"""Transport — the compressed client-delta wire protocol, on both legs.

The port of ``repro.core.engine.transport``. Clients ship *encoded deltas*
and the server aggregates the payloads through the fused kernels of
``kernels.delta_codec``, never decoding a client to full precision.

Uplink codecs:

  * ``none``   — ``get_transport("none")`` is None: the round core keeps its
    plain aggregator path. ``IdentityTransport`` is the same contract
    spelled through the protocol.
  * ``int8``   — per-leaf int8 quantisation of the flattened delta
    (``models.attention.quantize_kv``: per-vector max/127 scale), one int8
    plane on the wire; the quantisation residual folds into the
    server-side error-feedback state.
  * ``int8x2`` — primary and residual int8 planes (``quantize_kv_residual``),
    no feedback state.
  * ``topk``   — magnitude top-k of the flattened delta (f32 value + int32
    index) with server-side error feedback.

Error feedback lives at the server, at the aggregate level (clients are
stateless and resampled): each client encodes ``delta_c + residual``; the
new residual is ``sum_c w_c (delta_c + residual) - hat``. With a fixed
cohort (``FixedCohortSampler``, whose slot j is always cohort[j]) the
trainer binds the codec with ``with_ef_slots(n)``: the residual becomes
``(n, ...)`` per leaf, slot j encodes ``delta_j + residual_j`` and keeps its
own compression error ``delta_j + residual_j - decode_j`` (reference
:93-111, :191-253). Compressed codecs need a linear aggregator
(``LINEAR_AGGREGATORS``).

Downlink (``DownlinkCodec``): the server keeps the last broadcast
reference ``params_ref`` and encodes ``params - params_ref [+ residual]``;
every client trains from ``recon = params_ref + decode(payload)`` (the
decode-apply kernels), which is also the next reference. ``ref_store="q8"``
keeps reference and residual as two-level int8 leaves.
``AdaptiveDownlinkCodec`` picks a level per round (skip / one plane / two
planes) with plain tensor code; its level rides out of the round so the
trainer charges the wire per level.

On a mesh (``MeshBackend``) a codec is bound with ``with_mesh``: each rank
holds its own client rows, ``reduce`` runs the client-sharded kernels
(``ops.*_sharded``: the kernel on this rank's rows, then an all-reduce),
the error-feedback sum is all-reduced, and the int8 ``decode_apply`` cuts
the vector into one slice a rank where the ranks divide it.

Payloads are lists with one dict per parameter leaf, in ``tree_leaves``
order. ``encode(..., stacked=True)`` takes leaves with a leading client
axis and works on the (N, M) rows directly (per-row amax for int8,
``torch.topk`` per row for top-k); ``decode(..., stacked=True)`` turns such
payloads back into (N, ...) leaves. ``torch.topk`` promises no order among
ties, where ``lax.top_k`` prefers the lower index: compare decoded deltas,
never raw indices.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.api.registries import TRANSPORT_REGISTRY, register_transport
from repro_torch.kernels import ops as kops
from repro_torch.kernels.collectives import all_reduce_tiers, axes_size
from repro_torch.models.attention import quantize_kv, quantize_kv_residual
from repro_torch.optim import tree_leaves, tree_map

PyTree = Any

REF_STORES = ("f32", "q8")
# AdaptiveDownlinkCodec's level policy (the reference's defaults)
ADAPTIVE_SKIP_RTOL = 1e-3
ADAPTIVE_BOOST_RTOL = 0.5


def _numel(params: PyTree) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(params))


def _unflatten(like: PyTree, leaves) -> PyTree:
    """``leaves`` (in ``tree_leaves`` order) in the dict structure of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _flat(leaf: torch.Tensor, stacked: bool) -> torch.Tensor:
    """f32 view of a leaf as (M,), or as (N, M) rows for a client stack."""
    x = leaf.to(torch.float32)
    return x.reshape(x.shape[0], -1) if stacked else x.reshape(-1)


def _add_to(ref: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
    return (ref.to(torch.float32) + dec).to(ref.dtype)


def _shape(x: torch.Tensor, leaf: torch.Tensor, stacked: bool) -> tuple:
    """A decoded leaf's shape: ``leaf``'s, after the client axis of ``x``
    when ``stacked``."""
    return (x.shape[0],) + tuple(leaf.shape) if stacked else leaf.shape


class Transport:
    """Protocol. ``encode`` maps a delta tree to a payload list, ``reduce``
    consumes the stacked payloads of the round's clients."""

    name: str = "base"
    error_feedback: bool = False
    #: None: one server-aggregate residual; an int n: one residual slot a
    #: client of an n-client fixed cohort (``with_ef_slots``)
    ef_slots: Optional[int] = None
    # the mesh a bound copy reduces over (``with_mesh``); None: one device
    _mesh = None
    _client_axes: Optional[tuple] = None
    _reduce_tiers: Optional[tuple] = None

    def signature(self) -> tuple:
        """What tells two codec configurations apart (the reference keys its
        compile cache on it)."""
        return (self.name, self.error_feedback, self.ef_slots)

    def with_ef_slots(self, n: int) -> "Transport":
        """A copy with per-client error feedback for an ``n``-client fixed
        cohort; the codec itself for codecs without feedback state."""
        if not self.error_feedback:
            return self
        t = copy.copy(self)
        t.ef_slots = int(n)
        return t

    def with_mesh(self, mesh, client_axes: Sequence[str],
                  reduce_tiers=None) -> "Transport":
        """A copy bound to ``mesh``: ``reduce`` routes through the
        client-sharded kernels over ``client_axes`` (``reduce_tiers``: one
        all-reduce a tier, innermost first)."""
        t = copy.copy(self)
        t._mesh = mesh
        t._client_axes = tuple(client_axes)
        t._reduce_tiers = (tuple(tuple(tier) for tier in reduce_tiers)
                           if reduce_tiers else None)
        return t

    def _mesh_kw(self) -> dict:
        return dict(mesh=self._mesh, client_axes=self._client_axes,
                    reduce_tiers=self._reduce_tiers)

    def init_state(self, params: PyTree):
        """The error-feedback residual: f32 zeros shaped like ``params``, with
        a leading ``ef_slots`` axis for per-client feedback (``()`` for codecs
        without feedback)."""
        if not self.error_feedback:
            return ()
        lead = (self.ef_slots,) if self.ef_slots else ()
        return tree_map(lambda p: torch.zeros(lead + tuple(p.shape),
                                              dtype=torch.float32,
                                              device=p.device), params)

    def encode(self, delta: PyTree, stacked: bool = False):
        raise NotImplementedError

    def decode(self, payload, like: PyTree, stacked: bool = False) -> PyTree:
        """Payloads -> the delta tree shaped like ``like``; ``stacked``:
        payloads of ``encode(..., stacked=True)``, leaves (N, ...)."""
        raise NotImplementedError

    def reduce(self, payloads, weights: torch.Tensor, like: PyTree) -> PyTree:
        """Stacked payloads (leading client axis) -> the weighted-sum delta
        tree, through the fused kernels."""
        raise NotImplementedError

    def decode_apply(self, payload, ref: PyTree) -> PyTree:
        """``ref + decode(payload)``, the downlink reconstruction."""
        return tree_map(_add_to, ref, self.decode(payload, like=ref))

    def encoded_bits(self, params: PyTree) -> int:
        """Uplink bits one client pays per round for this codec."""
        raise NotImplementedError

    def compression_ratio(self, params: PyTree,
                          bits_per_param: int = 32) -> float:
        full = bits_per_param * _numel(params)
        return full / float(self.encoded_bits(params))

    def nominal_ratio(self, bits_per_param: int = 32) -> float:
        """Asymptotic ratio (scale overhead -> 0 at model scale)."""
        raise NotImplementedError

    def aggregate(self, aggregator, params: PyTree, client_stack: PyTree,
                  weights: torch.Tensor, state):
        """(params, client-stacked params (N, ...), weights (N,), state) ->
        (aggregate tree, new state). Compressed codecs ignore the
        aggregator (checked linear upstream) and work in delta space."""
        del aggregator
        hat, true, new_state = self.aggregate_slab(params, client_stack,
                                                   weights, state)
        if self.error_feedback and not self.ef_slots:
            new_state = tree_map(torch.sub, true, hat)
        return tree_map(_add_to, params, hat), new_state

    def aggregate_slab(self, params: PyTree, client_stack: PyTree,
                       weights: torch.Tensor, state):
        """The wire body of a round, or of one C-client slab of a streaming
        round (reference :223-260): delta -> error-feedback compensation ->
        encode -> fused reduce, returning the partial sums instead of
        applying them. ``aggregate`` runs it on the whole cohort, so C == U
        is the dense round by construction.

        ``weights`` are the clients' slice of the round's global weights,
        so slab partials add up to the round's sums. ``state`` is the
        feedback the clients meet: their slice of the per-client residual
        slots, or the round's aggregate residual (read only: the round's
        end sets the new one to sum(true) - sum(hat)). Returns ``(hat,
        true, new_state)``: ``hat`` the weighted sum of decoded deltas,
        ``true`` the weighted sum of the compensated deltas (aggregate
        feedback only, else ``()``), ``new_state`` the slots' own
        compression errors (per-client feedback) or ``state``."""
        deltas = tree_map(lambda cp, p: cp.to(torch.float32)
                          - p.to(torch.float32)[None], client_stack, params)
        if self.error_feedback:
            # per-client slots add their own residual; the aggregate
            # residual goes to every client
            deltas = (tree_map(torch.add, deltas, state) if self.ef_slots
                      else tree_map(lambda d, r: d + r[None], deltas, state))
        payloads = self.encode(deltas, stacked=True)
        hat = self.reduce(payloads, weights, like=params)
        if not self.error_feedback:
            return hat, (), state
        if self.ef_slots:
            # each slot keeps its own compression error; hat stays on the
            # fused reduce, so the aggregate is the same program in both
            # feedback modes (reference :236-249)
            return hat, (), tree_map(torch.sub, deltas,
                                     self.decode(payloads, like=params,
                                                 stacked=True))
        w32 = weights.to(torch.float32)
        true = [torch.tensordot(w32, d, dims=1) for d in tree_leaves(deltas)]
        if self._mesh is not None:          # every rank's clients
            true = [all_reduce_tiers(t, **self._mesh_kw()) for t in true]
        return hat, _unflatten(params, true), state


class IdentityTransport(Transport):
    """The degenerate codec: payloads are the client params and
    aggregation is the configured aggregator's."""

    name = "none"

    def encode(self, delta, stacked=False):
        return tree_leaves(delta)

    def decode(self, payload, like, stacked=False):
        return _unflatten(like, payload)

    def encoded_bits(self, params):
        return 32 * _numel(params)

    def nominal_ratio(self, bits_per_param: int = 32) -> float:
        return 1.0

    def aggregate(self, aggregator, params, client_stack, weights, state):
        return aggregator(client_stack, weights), state


class Int8Transport(Transport):
    """Q-KV int8 codec on the flattened per-leaf delta: ``levels=1``
    (``int8``, with error feedback) or ``levels=2`` (``int8x2``)."""

    name = "int8"

    def __init__(self, levels: int = 1, error_feedback: bool = True):
        if levels not in (1, 2):
            raise ValueError(f"int8 transport levels must be 1 or 2: {levels}")
        self.levels = levels
        self.error_feedback = error_feedback
        if levels == 2:
            self.name = "int8x2"

    def encode(self, delta, stacked=False):
        out = []
        for leaf in tree_leaves(delta):
            flat = _flat(leaf, stacked)
            if self.levels == 1:
                q, s = quantize_kv(flat)
                out.append({"q": q, "s": s})
            else:
                q, s, qr, rs = quantize_kv_residual(flat)
                out.append({"q": q, "s": s, "qr": qr, "rs": rs})
        return out

    def signature(self):
        return (self.name, self.levels, self.error_feedback, self.ef_slots)

    def decode(self, payload, like, stacked=False):
        dec = []
        for pl, leaf in zip(payload, tree_leaves(like)):
            x = pl["q"].to(torch.float32) * pl["s"]
            if self.levels == 2:
                x = x + pl["qr"].to(torch.float32) * pl["rs"]
            dec.append(x.reshape(_shape(x, leaf, stacked)))
        return _unflatten(like, dec)

    def reduce(self, payloads, weights, like):
        w32 = weights.to(torch.float32)
        out = []
        for pl, leaf in zip(payloads, tree_leaves(like)):
            two = self.levels == 2
            args = (pl["q"], w32 * pl["s"][:, 0], pl["qr"] if two else None,
                    w32 * pl["rs"][:, 0] if two else None)
            flat = (kops.int8_delta_reduce(*args) if self._mesh is None else
                    kops.int8_delta_reduce_sharded(*args, **self._mesh_kw()))
            out.append(flat.reshape(leaf.shape))
        return _unflatten(like, out)

    def decode_apply(self, payload, ref):
        size = axes_size(self._mesh, self._client_axes)
        out = []
        for pl, leaf in zip(payload, tree_leaves(ref)):
            args = (leaf.reshape(-1), pl["q"], pl["s"], pl.get("qr"),
                    pl.get("rs"))
            # one slice a rank where the ranks divide the vector (the
            # reference's condition), else the whole vector on every rank
            if self._mesh is not None and leaf.numel() % size == 0:
                rec = kops.int8_delta_apply_sharded(
                    *args, mesh=self._mesh, axes=self._client_axes)
            else:
                rec = kops.int8_delta_apply(*args)
            out.append(rec.reshape(leaf.shape))
        return _unflatten(ref, out)

    def encoded_bits(self, params):
        # int8 planes + one f32 scale per leaf and level
        return sum(self.levels * (8 * int(leaf.numel()) + 32)
                   for leaf in tree_leaves(params))

    def nominal_ratio(self, bits_per_param: int = 32) -> float:
        return bits_per_param / (8.0 * self.levels)


class TopKTransport(Transport):
    """Magnitude top-k of the flattened per-leaf delta (f32 value + int32
    index per kept coordinate) with server-side error feedback."""

    name = "topk"
    error_feedback = True

    def __init__(self, frac: float = 0.1):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1]: {frac}")
        self.frac = float(frac)

    def _k(self, size: int) -> int:
        # in [1, size]: ceil can round below 1 on tiny leaves; empty leaves
        # ship an empty payload
        return min(size, max(1, int(math.ceil(self.frac * size))))

    def encode(self, delta, stacked=False):
        out = []
        for leaf in tree_leaves(delta):
            flat = _flat(leaf, stacked)
            idx = torch.topk(torch.abs(flat), self._k(flat.shape[-1]),
                             dim=-1).indices
            out.append({"v": torch.gather(flat, -1, idx),
                        "i": idx.to(torch.int32)})
        return out

    def signature(self):
        return (self.name, self.frac, self.error_feedback, self.ef_slots)

    def decode(self, payload, like, stacked=False):
        dec = []
        for pl, leaf in zip(payload, tree_leaves(like)):
            v = pl["v"]
            flat = torch.zeros(v.shape[:-1] + (int(leaf.numel()),),
                               dtype=torch.float32, device=v.device)
            x = flat.scatter(-1, pl["i"].to(torch.int64), v)
            dec.append(x.reshape(_shape(x, leaf, stacked)))
        return _unflatten(like, dec)

    def reduce(self, payloads, weights, like):
        w32 = weights.to(torch.float32)
        out = []
        for pl, leaf in zip(payloads, tree_leaves(like)):
            args = (pl["v"], pl["i"], w32, int(leaf.numel()))
            flat = (kops.topk_delta_reduce(*args) if self._mesh is None else
                    kops.topk_delta_reduce_sharded(*args, **self._mesh_kw()))
            out.append(flat.reshape(leaf.shape))
        return _unflatten(like, out)

    def decode_apply(self, payload, ref):
        return _unflatten(ref, [
            kops.topk_delta_apply(leaf.reshape(-1), pl["v"], pl["i"]
                                  ).reshape(leaf.shape)
            for pl, leaf in zip(payload, tree_leaves(ref))])

    def encoded_bits(self, params):
        # f32 value + int32 index per kept coordinate
        return sum(64 * self._k(int(leaf.numel()))
                   for leaf in tree_leaves(params))

    def nominal_ratio(self, bits_per_param: int = 32) -> float:
        return bits_per_param / (64.0 * self.frac)


# ---------------------------------------------------------------------------
# downlink
# ---------------------------------------------------------------------------

def _q8_encode(x: torch.Tensor) -> dict:
    """A params leaf -> a two-level int8 store leaf (key names prefixed so a
    store leaf is never taken for a params subtree)."""
    q, s, qr, rs = quantize_kv_residual(x.to(torch.float32).reshape(-1))
    return {"q8_q": q, "q8_s": s, "q8_qr": qr, "q8_rs": rs}


def _q8_decode(d: dict, like: torch.Tensor) -> torch.Tensor:
    x = (d["q8_q"].to(torch.float32) * d["q8_s"]
         + d["q8_qr"].to(torch.float32) * d["q8_rs"])
    return x.reshape(like.shape).to(like.dtype)


def _map_like(fn, like: PyTree, stored: PyTree) -> PyTree:
    """Map ``fn(like_leaf, stored_node)`` over the leaves of ``like``: a q8
    store leaf is a dict, which ``tree_map`` would descend into."""
    if isinstance(like, dict):
        return {k: _map_like(fn, v, stored[k]) for k, v in like.items()}
    return fn(like, stored)


class DownlinkCodec:
    """Server->client broadcast compression around one of the codecs above.

    State (server-side, engine-owned): ``ref`` — the last broadcast
    reconstruction, the model every client holds; ``res`` — the downlink
    error-feedback residual (codecs with feedback). Per round:
    ``payload = enc(params - ref + res)``; clients train from
    ``recon = ref + dec(payload)``; the new reference is ``recon`` and
    ``res' = (delta + res) - dec(payload)``."""

    def __init__(self, codec: Transport, ref_store: str = "f32"):
        if codec is None or getattr(codec, "name", "none") == "none":
            raise ValueError("DownlinkCodec wraps a real codec; use "
                             "downlink='none' for the uncompressed "
                             "broadcast")
        if ref_store not in REF_STORES:
            raise ValueError(f"downlink ref_store must be one of "
                             f"{REF_STORES}: {ref_store!r}")
        self.codec = codec
        self.name = codec.name
        self.error_feedback = bool(codec.error_feedback)
        self.ref_store = ref_store

    def signature(self) -> tuple:
        """The codec's part of a bucket program's registry key
        (``RoundEngine``), the reference's tuple."""
        sig = ("downlink",) + tuple(self.codec.signature())
        if self.ref_store != "f32":
            sig = sig + ("ref:" + self.ref_store,)
        return sig

    def with_mesh(self, mesh, client_axes: Sequence[str],
                  reduce_tiers=None) -> "DownlinkCodec":
        """A copy whose codec is bound to ``mesh``: the broadcast's int8
        decode-apply runs one slice of each leaf a rank (the server
        encode stays replicated on every rank)."""
        t = copy.copy(self)
        t.codec = self.codec.with_mesh(mesh, client_axes, reduce_tiers)
        return t

    # -- quantised ref store ---------------------------------------------
    def store_tree(self, tree: PyTree) -> PyTree:
        """Params-shaped f32-equivalent tree -> stored representation."""
        if self.ref_store == "f32":
            return tree
        return tree_map(_q8_encode, tree)

    def load_tree(self, stored: PyTree, like: PyTree) -> PyTree:
        """Stored representation -> params-shaped tree (``like`` gives
        shapes and dtypes)."""
        if self.ref_store == "f32":
            return stored
        return _map_like(lambda leaf, d: _q8_decode(d, leaf), like, stored)

    # -- state -------------------------------------------------------------
    def init_state(self, params: PyTree):
        ref = self.store_tree(params)
        res = (self.store_tree(tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))
            if self.error_feedback else ())
        return {"ref": ref, "res": res}

    # -- the round entry points --------------------------------------------
    def _delta(self, params: PyTree, ref: PyTree) -> PyTree:
        return tree_map(lambda p, r: p.to(torch.float32)
                        - r.to(torch.float32), params, ref)

    def encode_broadcast(self, params: PyTree, state):
        """(server params, state) -> (ref, payload, recon, new state):
        ``ref`` is the f32-equivalent reference view, ``recon`` the
        clients' reconstruction (through the decode-apply kernels)."""
        ref = self.load_tree(state["ref"], like=params)
        delta = self._delta(params, ref)
        res = ()
        if self.error_feedback:
            delta = tree_map(torch.add, delta,
                             self.load_tree(state["res"], like=params))
        payload = self.codec.encode(delta)
        recon = self.decode_into(payload, ref)
        if self.error_feedback:
            res = self.store_tree(tree_map(
                torch.sub, delta, self.codec.decode(payload, like=params)))
        return ref, payload, recon, {"ref": self.store_tree(recon),
                                     "res": res}

    def decode_into(self, payload, ref: PyTree) -> PyTree:
        """The clients' reconstruction ``ref + dec(payload)``."""
        return self.codec.decode_apply(payload, ref)

    # -- wire accounting -----------------------------------------------------
    def encoded_bits(self, params: PyTree) -> int:
        return self.codec.encoded_bits(params)

    def compression_ratio(self, params: PyTree,
                          bits_per_param: int = 32) -> float:
        return self.codec.compression_ratio(params, bits_per_param)

    def nominal_ratio(self, bits_per_param: int = 32) -> float:
        return self.codec.nominal_ratio(bits_per_param)


class AdaptiveDownlinkCodec(DownlinkCodec):
    """Per-round adaptive broadcast over the two-level int8 quantiser.

    Level 0 (skip): ``|delta|`` is below ``ADAPTIVE_SKIP_RTOL * |ref|``;
    nothing is shipped and the delta folds into the residual. Level 2
    (boost): the residual norm exceeds ``ADAPTIVE_BOOST_RTOL * |delta|``;
    both planes ship. Level 1: the primary plane. Both planes are always
    computed and the level masks the decode (plain tensor code, no kernel),
    so the level stays on the device; ``encode_broadcast`` returns it as an
    int32 scalar."""

    def __init__(self, *, ref_store: str = "f32"):
        super().__init__(Int8Transport(levels=2, error_feedback=True),
                         ref_store=ref_store)
        self.name = "adaptive"

    def signature(self) -> tuple:
        sig = ("downlink", "adaptive", ADAPTIVE_SKIP_RTOL,
               ADAPTIVE_BOOST_RTOL)
        if self.ref_store != "f32":
            sig = sig + ("ref:" + self.ref_store,)
        return sig

    @staticmethod
    def _norm(tree) -> torch.Tensor:
        leaves = [torch.sum(torch.square(leaf.to(torch.float32)))
                  for leaf in tree_leaves(tree)]
        return torch.sqrt(sum(leaves)) if leaves else torch.zeros(())

    def _level(self, delta, ref, res) -> torch.Tensor:
        nd, nref, nres = self._norm(delta), self._norm(ref), self._norm(res)
        ship = nd > ADAPTIVE_SKIP_RTOL * (nref + 1e-12)
        boost = nres > ADAPTIVE_BOOST_RTOL * (nd + 1e-12)
        return torch.where(ship, torch.where(boost, 2, 1), 0).to(torch.int32)

    def encode_broadcast(self, params: PyTree, state):
        """Returns ``(ref, payload, recon, new_state, level)``."""
        ref = self.load_tree(state["ref"], like=params)
        res32 = self.load_tree(state["res"], like=params)
        delta = self._delta(params, ref)
        level = self._level(delta, ref, res32)  # on the raw round delta
        delta = tree_map(torch.add, delta, res32)
        payload = [dict(pl, lvl=level) for pl in self.codec.encode(delta)]
        recon = self.decode_into(payload, ref)
        res = self.store_tree(tree_map(torch.sub, delta,
                                       self._decode(payload, like=params)))
        return ref, payload, recon, {"ref": self.store_tree(recon),
                                     "res": res}, level

    def _decode(self, payload, like: PyTree) -> PyTree:
        """Level-masked dequantise: level 0 decodes to zero, level 1 the
        primary plane, level 2 both planes."""
        dec = []
        for pl, leaf in zip(payload, tree_leaves(like)):
            lvl = pl["lvl"]
            x = torch.where(lvl >= 1, pl["q"].to(torch.float32) * pl["s"],
                            0.0)
            x = x + torch.where(lvl >= 2,
                                pl["qr"].to(torch.float32) * pl["rs"], 0.0)
            dec.append(x.reshape(leaf.shape))
        return _unflatten(like, dec)

    def decode_into(self, payload, ref: PyTree) -> PyTree:
        return tree_map(_add_to, ref, self._decode(payload, like=ref))

    # -- wire accounting: nominal = the level-1 broadcast --------------------
    def _level_bits(self, params: PyTree, level: int) -> int:
        if level <= 0:
            return 0
        return sum(level * (8 * int(leaf.numel()) + 32)
                   for leaf in tree_leaves(params))

    def encoded_bits(self, params: PyTree) -> int:
        return self._level_bits(params, 1)

    def compression_ratio(self, params: PyTree,
                          bits_per_param: int = 32) -> float:
        return bits_per_param * _numel(params) / float(
            self.encoded_bits(params))

    def level_ratios(self, params: PyTree,
                     bits_per_param: int = 32) -> dict:
        """{level: compression ratio} for the runtime model's per-level wire
        charge (level 0 ships nothing)."""
        full = bits_per_param * _numel(params)
        return {lvl: full / float(self._level_bits(params, lvl))
                for lvl in (1, 2)}

    def nominal_ratio(self, bits_per_param: int = 32) -> float:
        return bits_per_param / 8.0


def get_downlink(name: Optional[str], *, topk_frac: float = 0.1,
                 ref_store: str = "f32") -> Optional[DownlinkCodec]:
    """The broadcast codec, resolved through ``TRANSPORT_REGISTRY``: any
    uplink codec wrapped in a ``DownlinkCodec``, or a downlink-only codec
    (``adaptive``). ``None``/``"none"`` -> None (the uncompressed
    broadcast); a ``DownlinkCodec`` passes through."""
    if name is None or isinstance(name, DownlinkCodec):
        return name
    codec = (name if isinstance(name, Transport)
             else TRANSPORT_REGISTRY.get(name)(topk_frac=topk_frac,
                                               ref_store=ref_store))
    if codec is None or isinstance(codec, DownlinkCodec):
        return codec
    return DownlinkCodec(codec, ref_store=ref_store)


def get_transport(name, *, topk_frac: float = 0.1) -> Optional[Transport]:
    """The uplink codec through ``TRANSPORT_REGISTRY``, or a ``Transport``
    (which passes through). ``None``/``"none"`` -> None; downlink-only
    codecs are refused."""
    if name is None or isinstance(name, Transport):
        return name
    if isinstance(name, DownlinkCodec):
        raise ValueError(f"{name.name!r} is a downlink-only codec; it is "
                         f"valid for transport.downlink, not "
                         f"transport.name")
    codec = TRANSPORT_REGISTRY.get(name)(topk_frac=topk_frac)
    if isinstance(codec, DownlinkCodec):
        raise ValueError(f"{codec.name!r} is a downlink-only codec; it is "
                         f"valid for transport.downlink, not "
                         f"transport.name")
    return codec


# builtin registrations: factory(*, topk_frac, ref_store, **kw); top-k runs
# error feedback only, the one form the reference registers
register_transport("none", lambda **kw: None)
register_transport("int8",
                   lambda **kw: Int8Transport(levels=1, error_feedback=True))
register_transport("int8x2",
                   lambda **kw: Int8Transport(levels=2, error_feedback=False))
register_transport("topk",
                   lambda *, topk_frac=0.1, **kw: TopKTransport(frac=topk_frac))
register_transport(
    "adaptive",
    lambda *, ref_store="f32", **kw: AdaptiveDownlinkCodec(
        ref_store=ref_store))
