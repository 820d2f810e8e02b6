"""The port's wire path against the reference's: the int8 quantisers, the
plain versions of the four delta-codec kernels (against the Pallas kernels
in interpret mode), every codec and the downlink state machines, the
per-level runtime charge, and ``FedAvgTrainer`` over uplink x downlink
codec pairs on FEMNIST. Same numpy inputs to both packages throughout.

Tolerances. Codec-level inputs are identical, so ``q`` must agree (one step
apart only at an exact .5 tie) and scales within one f32 ulp. Sums taken in
another order (the reduces) agree to ``RTOL`` relative to the largest
output. Across frameworks losses and gradients differ by ~5e-7, so a value
within ~1e-9 of a rounding boundary may quantise one step apart. One round
started from the reference's own state is therefore held within one
quantisation step (the round's movement / 127) plus the slice-1 tolerance.
Whole trainer runs agree on every integer and accounting figure exactly;
their losses and parameters carry the earlier rounds' step differences
forward, and are held to bounds set from measured readings
(``DRIFT_LIMITS``; ``python tests/test_torch_transport.py`` prints them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FedConfig as JFed
from repro.configs import get_paper_task as jax_task
from repro.core import FedAvgTrainer as JTrainer
from repro.core import RuntimeModel as JRuntime
from repro.core.engine import transport as jt
from repro.kernels import delta_codec as jdc
from repro.models import attention as jatt
from repro.models import small as jsmall
from repro_torch.configs import FedConfig, get_paper_task
from repro_torch.core import FedAvgTrainer, RuntimeModel
from repro_torch.core.engine import transport as tt
from repro_torch.core.engine.round import RoundEngine
from repro_torch.data import make_paper_task
from repro_torch.kernels import delta_codec as tdc
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tatt
from repro_torch.models import small
from test_torch_parity_helpers import (TOL, _np, _torch, drift_in_steps, flat,
                                       record_ids, to_port_state)

RTOL = 1e-5          # reduces: f32 sums of <= 25 terms in another order
# trainer losses after 3 rounds of wire quantisation (see DRIFT_LIMITS)
LOSS_RTOL = 1e-4


def _t(x):
    return torch.tensor(np.asarray(x))


def _close_to_max(got, want, rtol=RTOL):
    """Elementwise within ``rtol`` of the largest |want| (sums in another
    order cancel differently, so a relative bound per element is wrong)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _assert_q_equal(tq, jq, x, s):
    """Same int8 values, except one step apart where x/s is an exact .5
    tie (the only place two correct roundings may differ)."""
    tq, jq = np.asarray(tq, np.int32), np.asarray(jq, np.int32)
    diff = np.abs(tq - jq)
    assert diff.max(initial=0) <= 1
    ratio = np.asarray(x, np.float32) / np.asarray(s, np.float32)
    tie = np.abs(ratio - np.trunc(ratio)) == 0.5
    assert np.all(tie[diff == 1])


def _assert_scale_close(ts, js):
    np.testing.assert_allclose(np.asarray(ts), np.asarray(js),
                               rtol=2 ** -23, atol=0)


# ---------------------------------------------------------------------------
# quantisers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (6, 513), (25, 100), (3, 1)])
@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_quantizers_match_reference(shape, scale):
    rng = np.random.default_rng(shape[0] * 7 + int(scale))
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x[..., 0] = 0.5 * scale             # a value that lands on a tie grid
    tq, ts = tatt.quantize_kv(torch.tensor(x))
    jq, js = jatt.quantize_kv(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == shape[:-1] + (1,)
    _assert_scale_close(ts, js)
    _assert_q_equal(tq, jq, x, js)
    tout = tatt.quantize_kv_residual(torch.tensor(x))
    jout = jatt.quantize_kv_residual(jnp.asarray(x))
    _assert_q_equal(tout[0], jout[0], x, jout[1])
    _assert_scale_close(tout[1], jout[1])
    _assert_scale_close(tout[3], jout[3])
    res = x - np.asarray(jout[0], np.float32) * np.asarray(jout[1])
    _assert_q_equal(tout[2], jout[2], res, jout[3])


def test_quantizer_scale_floor_on_zero_vector():
    tq, ts = tatt.quantize_kv(torch.zeros(5))
    jq, js = jatt.quantize_kv(jnp.zeros(5))
    assert np.asarray(ts).item() == np.asarray(js).item() == np.float32(1e-8)
    assert not tq.any() and not np.asarray(jq).any()


# ---------------------------------------------------------------------------
# plain kernel versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _int8_planes(seed, n, m):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(n, m)).astype(np.int8)
    qr = rng.integers(-127, 128, size=(n, m)).astype(np.int8)
    w = rng.random(n).astype(np.float32) * 1e-3
    wr = rng.random(n).astype(np.float32) * 1e-5
    return q, qr, w, wr


@pytest.mark.parametrize("n,m", [(4, 512), (7, 1000), (25, 100), (3, 1),
                                 (6, 4099)])
@pytest.mark.parametrize("planes", [1, 2])
def test_int8_decompress_reduce_matches_pallas(n, m, planes):
    q, qr, w, wr = _int8_planes(n * m, n, m)
    two = planes == 2
    want = jdc.int8_decompress_reduce(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(qr) if two else None,
        jnp.asarray(wr) if two else None, interpret=True)
    before = dict(tdc.launches)
    got = tdc.int8_decompress_reduce(_t(q), _t(w), _t(qr) if two else None,
                                     _t(wr) if two else None)
    assert tdc.launches == before             # the CPU ran the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (m,)
    assert torch.equal(got, tref.int8_decompress_reduce_ref(
        _t(q), _t(w), _t(qr) if two else None, _t(wr) if two else None))
    _close_to_max(got.numpy(), want)


@pytest.mark.parametrize("m", [512, 1000, 1, 4099])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_decode_apply_matches_pallas(m, planes, dtype):
    q, qr, _, _ = _int8_planes(m, 1, m)
    rng = np.random.default_rng(m + 1)
    ref = rng.normal(size=m).astype(np.float32)
    s, rs = np.float32(3e-3), np.float32(2e-5)
    two = planes == 2
    jref = jnp.asarray(ref).astype(getattr(jnp, dtype))
    tref_ = torch.tensor(ref).to(getattr(torch, dtype))
    want = jdc.int8_decode_apply(
        jref, jnp.asarray(q[0]), jnp.asarray(s),
        jnp.asarray(qr[0]) if two else None,
        jnp.asarray(rs) if two else None, interpret=True)
    got = tdc.int8_decode_apply(
        tref_, _t(q[0]), torch.tensor([s]), _t(qr[0]) if two else None,
        torch.tensor([rs]) if two else None)
    assert got.dtype == tref_.dtype and tuple(got.shape) == (m,)
    # XLA may fuse ``ref + q*s`` into one FMA where the port rounds the
    # product first: half an ulp of the largest term apart, then (bf16) one
    # bf16 ulp after the cast
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close_to_max(got.numpy(), want, 2 ** -22)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -22 * np.abs(want).max())


def _topk_payload(seed, n, k, m):
    """(N, S) payload with indices drawn WITH replacement, so duplicates
    across and within rows are common."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    idx = rng.integers(0, max(m, 1), size=(n, k)).astype(np.int32)
    z = rng.normal(size=n)
    w = (np.exp(z) / np.exp(z).sum()).astype(np.float32)
    return vals, idx, w


@pytest.mark.parametrize("n,k,m", [(3, 5, 17), (8, 64, 1000), (1, 1, 1),
                                   (2, 7, 1), (5, 130, 4099)])
def test_topk_scatter_reduce_matches_pallas(n, k, m):
    vals, idx, w = _topk_payload(n * 1000 + k, n, k, m)
    want = jdc.topk_scatter_reduce_mosaic(jnp.asarray(vals), jnp.asarray(idx),
                                          jnp.asarray(w), m, interpret=True)
    got = tdc.topk_scatter_reduce(_t(vals), _t(idx), _t(w), m)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _collide_payload(seed, n, k, m):
    """(N, S) payload on which the order of the rows shows: every row holds
    the same S indices, each row in its own order, with values of +-1e8 and
    +-1 (weights 1), so a sum that takes the rows out of order rounds
    differently."""
    rng = np.random.default_rng(seed)
    base = rng.permutation(m)[:k]
    idx = np.stack([rng.permutation(base) for _ in range(n)]).astype(np.int32)
    vals = rng.choice([1e8, -1e8, 1.0, -1.0], size=(n, k)).astype(np.float32)
    return vals, idx, np.ones(n, np.float32)


@pytest.mark.parametrize("n,k,m", [(25, 256, 1024), (60, 512, 700)])
def test_topk_scatter_reduce_keeps_client_order_like_pallas(n, k, m):
    """S a multiple of the Pallas kernel's payload block (256): each block
    lies in one row, so its output tile takes the rows in client order, as
    the plain version (and the CUDA kernel) does; on this payload another
    order gives another sum."""
    vals, idx, w = _collide_payload(n * k, n, k, m)
    want = jdc.topk_scatter_reduce_mosaic(jnp.asarray(vals), jnp.asarray(idx),
                                          jnp.asarray(w), m, interpret=True)
    got = tdc.topk_scatter_reduce(_t(vals), _t(idx), _t(w), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    flipped = tdc.topk_scatter_reduce(_t(vals[::-1].copy()),
                                      _t(idx[::-1].copy()), _t(w), m)
    assert not np.array_equal(flipped.numpy(), got.numpy())


def test_topk_scatter_reduce_edge_cases_match_pallas():
    # duplicates within and across rows accumulate
    vals = np.array([[1.0, 2.0, 4.0], [8.0, 16.0, 32.0]], np.float32)
    idx = np.array([[0, 0, 3], [3, 1, 0]], np.int32)
    w = np.array([1.0, 0.5], np.float32)
    got = tdc.topk_scatter_reduce(_t(vals), _t(idx), _t(w), 5)
    np.testing.assert_array_equal(
        got.numpy(), np.array([1 + 2 + 16, 8, 0, 4 + 4, 0], np.float32))
    # -1 padding matches nothing
    idx_pad = np.array([[0, -1, 3], [-1, 1, -1]], np.int32)
    want = jdc.topk_scatter_reduce_mosaic(jnp.asarray(vals),
                                          jnp.asarray(idx_pad),
                                          jnp.asarray(w), 5, interpret=True)
    got = tdc.topk_scatter_reduce(_t(vals), _t(idx_pad), _t(w), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1, 8, 0, 4, 0])
    # an empty payload is an exact zero reduction
    got = tdc.topk_scatter_reduce(torch.zeros((2, 0)),
                                  torch.zeros((2, 0), dtype=torch.int32),
                                  torch.tensor([0.5, 0.5]), 37)
    want = jdc.topk_scatter_reduce_mosaic(
        jnp.zeros((2, 0)), jnp.zeros((2, 0), jnp.int32),
        jnp.array([0.5, 0.5]), 37, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.any()


@pytest.mark.parametrize("s,m", [(6, 40), (1, 1), (130, 4099)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_scatter_apply_matches_pallas(s, m, dtype):
    rng = np.random.default_rng(s * m)
    ref = rng.normal(size=m).astype(np.float32)
    vals = rng.normal(size=s).astype(np.float32)
    idx = rng.permutation(m)[:s].astype(np.int32)
    jref = jnp.asarray(ref).astype(getattr(jnp, dtype))
    tref_ = torch.tensor(ref).to(getattr(torch, dtype))
    want = jdc.topk_scatter_apply_mosaic(jref, jnp.asarray(vals),
                                         jnp.asarray(idx), interpret=True)
    got = tdc.topk_scatter_apply(tref_, _t(vals), _t(idx))
    assert got.dtype == tref_.dtype
    # distinct indices: one f32 add per slot in both, so bit for bit
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_topk_scatter_apply_edge_cases_match_pallas():
    ref = np.array([10.0, 20.0, 30.0], np.float32)
    vals = np.array([1.0, 2.0, 4.0], np.float32)
    for idx in ([2, 2, 0], [2, -1, 0]):          # a duplicate; -1 padding
        idx = np.array(idx, np.int32)
        want = jdc.topk_scatter_apply_mosaic(jnp.asarray(ref),
                                             jnp.asarray(vals),
                                             jnp.asarray(idx), interpret=True)
        got = tdc.topk_scatter_apply(_t(ref), _t(vals), _t(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    empty = tdc.topk_scatter_apply(_t(ref), torch.zeros(0),
                                   torch.zeros(0, dtype=torch.int32))
    np.testing.assert_array_equal(empty.numpy(), ref)


@pytest.mark.parametrize("call", [
    lambda: tdc.int8_decompress_reduce(torch.zeros((2, 3)),
                                       torch.ones(2)),           # not int8
    lambda: tdc.int8_decompress_reduce(torch.zeros((2, 3), dtype=torch.int8),
                                       torch.ones(3)),           # bad w
    lambda: tdc.int8_decompress_reduce(torch.zeros((2, 3), dtype=torch.int8),
                                       torch.ones(2),
                                       torch.zeros((2, 3), dtype=torch.int8)),
    lambda: tdc.int8_decode_apply(torch.zeros(4),
                                  torch.zeros(3, dtype=torch.int8),
                                  torch.ones(1)),                # shape
    lambda: tdc.int8_decode_apply(torch.zeros(4, dtype=torch.float64),
                                  torch.zeros(4, dtype=torch.int8),
                                  torch.ones(1)),                # dtype
    lambda: tdc.topk_scatter_reduce(torch.zeros((2, 3)),
                                    torch.zeros((2, 3), dtype=torch.int64),
                                    torch.ones(2), 5),           # idx int64
    lambda: tdc.topk_scatter_apply(torch.zeros(5), torch.zeros(3),
                                   torch.zeros(2, dtype=torch.int32)),
    lambda: tdc.topk_scatter_apply(torch.zeros((5, 1)), torch.zeros(3),
                                   torch.zeros(3, dtype=torch.int32)),
    lambda: tdc.int8_decompress_reduce(
        torch.zeros((2, 4), dtype=torch.int8)[:, ::2], torch.ones(2)),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(call):
    with pytest.raises((TypeError, ValueError)):
        call()


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.fixture()
def deltas():
    """Sorted-key trees (both packages flatten them in the same order):
    params, client-stacked deltas (8, ...), weights (8,)."""
    rng = np.random.default_rng(0)
    params = {"b": rng.normal(size=(500,)).astype(np.float32),
              "w": rng.normal(size=(33, 7)).astype(np.float32)}
    d = {k: rng.normal(scale=0.01, size=(8,) + v.shape).astype(np.float32)
         for k, v in params.items()}
    w = (rng.random(8) + 0.1).astype(np.float32)
    return params, d, (w / w.sum()).astype(np.float32)


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


CODECS = [("int8", {}), ("int8x2", {}), ("topk", {"topk_frac": 0.1}),
          ("topk", {"topk_frac": 0.37})]


def _codecs(name, kw):
    return tt.get_transport(name, **kw), jt.get_transport(name, **kw)


def _assert_trees_close_to_max(got, want, rtol=RTOL, atol=0.0):
    fg, fw = flat(got), flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        scale = float(np.max(np.abs(fw[k]))) if fw[k].size else 0.0
        np.testing.assert_allclose(fg[k], fw[k], rtol=0,
                                   atol=rtol * scale + atol, err_msg=k)


@pytest.mark.parametrize("name,kw", CODECS)
def test_codec_encode_decode_matches_reference(deltas, name, kw):
    params, d, _ = deltas
    tcod, jcod = _codecs(name, kw)
    one = {k: v[0] for k, v in d.items()}
    tpay, jpay = tcod.encode(_torch(one)), jcod.encode(_jtree(one))
    assert len(tpay) == len(jpay) == 2
    for tp, jp, leaf in zip(tpay, jpay, [one["b"], one["w"]]):
        if name.startswith("int8"):
            _assert_scale_close(tp["s"], jp["s"])
            _assert_q_equal(tp["q"], jp["q"], leaf.reshape(-1), jp["s"])
        else:       # top-k: the same kept set (no ties in this data)
            assert sorted(tp["i"].tolist()) == sorted(
                np.asarray(jp["i"]).tolist())
            assert tp["i"].dtype == torch.int32
    tdec = tcod.decode(tpay, like=_torch(params))
    jdec = jcod.decode(jpay, like=_jtree(params))
    _assert_trees_close_to_max(tdec, jdec, 2 ** -23)
    trec = tcod.decode_apply(tpay, _torch(params))
    jrec = jcod.decode_apply(jpay, _jtree(params))
    _assert_trees_close_to_max(trec, jrec, 2 ** -23)
    assert tcod.encoded_bits(_torch(params)) == jcod.encoded_bits(
        _jtree(params))
    assert tcod.compression_ratio(_torch(params)) == \
        jcod.compression_ratio(_jtree(params))
    assert tcod.nominal_ratio() == jcod.nominal_ratio()


@pytest.mark.parametrize("name,kw", CODECS)
def test_codec_reduce_and_aggregate_match_reference(deltas, name, kw):
    params, d, w = deltas
    tcod, jcod = _codecs(name, kw)
    tpay = tcod.encode(_torch(d), stacked=True)
    jpay = jax.vmap(jcod.encode)(_jtree(d))
    assert tuple(tpay[1]["q" if "q" in tpay[1] else "v"].shape)[0] == 8
    _assert_trees_close_to_max(
        tcod.reduce(tpay, torch.tensor(w), like=_torch(params)),
        jcod.reduce(jpay, jnp.asarray(w), like=_jtree(params)))
    # the round-core entry point, with error feedback where the codec has it
    stack = {k: params[k][None] + d[k] for k in params}
    tstate, jstate = (tcod.init_state(_torch(params)),
                      jcod.init_state(_jtree(params)))
    tmean = lambda cp, ww: None           # compressed codecs ignore it
    for _ in range(2):
        tagg, tstate = tcod.aggregate(tmean, _torch(params), _torch(stack),
                                      torch.tensor(w), tstate)
        jagg, jstate = jcod.aggregate(None, _jtree(params), _jtree(stack),
                                      jnp.asarray(w), jstate)
        _assert_trees_close_to_max(tagg, jagg)
        if tcod.error_feedback:
            _assert_trees_close_to_max(tstate, jstate, 1e-4)
        else:
            assert tstate == () and jstate == ()


def test_identity_transport_delegates_to_the_aggregator(deltas):
    params, d, w = deltas
    ident = tt.IdentityTransport()
    stack = _torch({k: params[k][None] + d[k] for k in params})
    agg, state = ident.aggregate(lambda cp, ww: cp, _torch(params), stack,
                                 torch.tensor(w), ())
    assert agg is stack and state == ()
    assert ident.encoded_bits(_torch(params)) == \
        jt.IdentityTransport().encoded_bits(_jtree(params))
    assert ident.decode(ident.encode(stack), like=stack) == stack


def _drift(params, seed, rounds=3):
    """A server-param sequence: params plus growing noise per round."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        out.append({k: (v + rng.normal(scale=0.02 * (r + 1), size=v.shape)
                        ).astype(np.float32) for k, v in params.items()})
    return out


@pytest.mark.parametrize("name", ["int8", "int8x2", "topk"])
@pytest.mark.parametrize("ref_store", ["f32", "q8"])
def test_downlink_state_machine_matches_reference(deltas, name, ref_store):
    params = deltas[0]
    tcod = tt.get_downlink(name, ref_store=ref_store)
    jcod = jt.get_downlink(name, ref_store=ref_store)
    assert tcod.name == jcod.name and tcod.error_feedback == \
        jcod.error_feedback
    tstate, jstate = (tcod.init_state(_torch(params)),
                      jcod.init_state(_jtree(params)))
    # a q8 store re-quantises every reference: a ~1e-7 difference may land
    # one residual step (max|x|/127^2) apart, and the next delta with it
    q8 = (0.0 if ref_store == "f32" else
          2 * max(np.abs(v).max() for v in params.values()) / 127 ** 2)
    for p in _drift(params, seed=len(name)):
        tref_, _, trec, tstate = tcod.encode_broadcast(_torch(p), tstate)
        jref_, _, jrec, jstate = jcod.encode_broadcast(_jtree(p), jstate)
        _assert_trees_close_to_max(tref_, jref_, 1e-5, q8)
        _assert_trees_close_to_max(trec, jrec, 1e-5, q8)
        like_t, like_j = _torch(params), _jtree(params)
        _assert_trees_close_to_max(tcod.load_tree(tstate["ref"], like_t),
                                   jcod.load_tree(jstate["ref"], like_j),
                                   1e-5, q8)
        if tcod.error_feedback:
            _assert_trees_close_to_max(tcod.load_tree(tstate["res"], like_t),
                                       jcod.load_tree(jstate["res"], like_j),
                                       1e-3, q8)
    assert tcod.compression_ratio(_torch(params)) == \
        jcod.compression_ratio(_jtree(params))


def test_q8_store_round_trip_matches_reference(deltas):
    params = deltas[0]
    tcod = tt.DownlinkCodec(tt.Int8Transport(), ref_store="q8")
    jcod = jt.DownlinkCodec(jt.Int8Transport(), ref_store="q8")
    tst, jst = tcod.store_tree(_torch(params)), jcod.store_tree(
        _jtree(params))
    assert set(tst["w"]) == {"q8_q", "q8_s", "q8_qr", "q8_rs"}
    for k in params:
        for part in ("q8_s", "q8_rs"):
            _assert_scale_close(tst[k][part], jst[k][part])
    back = tcod.load_tree(tst, like=_torch(params))
    _assert_trees_close_to_max(back, jcod.load_tree(jst, _jtree(params)),
                               1e-6)
    for k in params:        # two int8 levels: ~max|x|/127^2 worst case
        assert np.max(np.abs(back[k].numpy() - params[k])) <= \
            np.max(np.abs(params[k])) / 127 ** 2


@pytest.mark.parametrize("ref_store", ["f32", "q8"])
def test_adaptive_downlink_levels_match_reference(deltas, ref_store):
    params = deltas[0]
    tcod = tt.get_downlink("adaptive", ref_store=ref_store)
    jcod = jt.get_downlink("adaptive", ref_store=ref_store)
    assert isinstance(tcod, tt.AdaptiveDownlinkCodec)
    tstate, jstate = (tcod.init_state(_torch(params)),
                      jcod.init_state(_jtree(params)))
    # round 1: params == ref -> skip; then drifting steps; then a tiny step
    # after a skipped big one, which leaves a residual larger than the step
    big = {k: (v + 0.5).astype(np.float32) for k, v in params.items()}
    seq = [params] + _drift(params, seed=3, rounds=2) + [big]
    tiny = {k: (v + 1e-3).astype(np.float32) for k, v in big.items()}
    seq.append(tiny)
    q8 = (0.0 if ref_store == "f32" else
          2 * max(np.abs(v).max() for v in big.values()) / 127 ** 2)
    levels = []
    for p in seq:
        tout = tcod.encode_broadcast(_torch(p), tstate)
        jout = jcod.encode_broadcast(_jtree(p), jstate)
        tstate, jstate = tout[3], jout[3]
        assert tout[4].dtype == torch.int32
        assert int(tout[4]) == int(jout[4])
        levels.append(int(tout[4]))
        _assert_trees_close_to_max(tout[2], jout[2], 1e-5, q8)
        _assert_trees_close_to_max(
            tcod.load_tree(tstate["res"], _torch(params)),
            jcod.load_tree(jstate["res"], _jtree(params)), 1e-3, q8)
    assert levels[0] == 0 and 1 in levels
    assert tcod.level_ratios(_torch(params)) == \
        jcod.level_ratios(_jtree(params))
    assert tcod.compression_ratio(_torch(params)) == \
        jcod.compression_ratio(_jtree(params))
    assert tcod.nominal_ratio() == jcod.nominal_ratio()


def test_adaptive_boosts_when_the_residual_outgrows_the_step():
    """A residual larger than ``ADAPTIVE_BOOST_RTOL`` x the round's step
    ships both planes (level 2), in both packages."""
    params = {"w": np.linspace(-1, 1, 64, dtype=np.float32)}
    res = {"w": np.full(64, 0.3, np.float32)}
    step = {"w": (params["w"] + 0.1).astype(np.float32)}
    tcod, jcod = tt.AdaptiveDownlinkCodec(), jt.AdaptiveDownlinkCodec()
    tout = tcod.encode_broadcast(_torch(step), {"ref": _torch(params),
                                                "res": _torch(res)})
    jout = jcod.encode_broadcast(_jtree(step), {"ref": _jtree(params),
                                                "res": _jtree(res)})
    assert int(tout[4]) == int(jout[4]) == 2


def test_codec_registry_and_refusals():
    assert tt.get_transport("none") is None and tt.get_transport(None) is None
    assert tt.get_downlink("none") is None
    assert isinstance(tt.get_transport("int8x2"), tt.Int8Transport)
    with pytest.raises(ValueError, match="downlink-only"):
        tt.get_transport("adaptive")
    with pytest.raises(ValueError, match="downlink-only"):
        jt.get_transport("adaptive")
    with pytest.raises(ValueError, match="unknown"):
        tt.get_transport("int4")
    with pytest.raises(ValueError, match="ref_store"):
        tt.get_downlink("int8", ref_store="q4")
    with pytest.raises(ValueError, match="frac"):
        tt.get_transport("topk", topk_frac=0.0)


# ---------------------------------------------------------------------------
# runtime model: per-level downlink charge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("het", [0.0, 0.5])
def test_runtime_model_downlink_levels_identical(het):
    task = get_paper_task("femnist")
    kw = dict(clients_per_round=6, heterogeneity=het, seed=3,
              uplink_compression=3.9, downlink_compression=3.8)
    a = RuntimeModel(task.model_size_mb, task.runtime, **kw)
    b = JRuntime(task.model_size_mb, jax_task("femnist").runtime, **kw)
    a.downlink_level_ratios = b.downlink_level_ratios = {1: 3.8, 2: 1.9}
    for level in (None, -1, 0, 1, 2):
        ca, cb = a.round_cost(7, downlink_level=level), b.round_cost(
            7, downlink_level=level)
        assert (ca.wall_clock_s, ca.sgd_steps, ca.uplink_mbit,
                ca.downlink_mbit) == (cb.wall_clock_s, cb.sgd_steps,
                                      cb.uplink_mbit, cb.downlink_mbit)
        np.testing.assert_array_equal(
            a.draw_client_times(4, [0, 2], 7, downlink_level=level),
            b.draw_client_times(4, [0, 2], 7, downlink_level=level))


# ---------------------------------------------------------------------------
# the trainer over codec pairs, against the reference trainer
# ---------------------------------------------------------------------------

def _femnist_setup():
    """As tests/test_transport.py sets it up: the paper DNN at full width,
    16 clients of 30 samples."""
    task = jax_task("femnist")
    data = make_paper_task("femnist", np.random.default_rng(0),
                           num_clients=16, samples_per_client=30)
    params = _np(jsmall.init_task_model(jax.random.PRNGKey(0), task))
    return task, data, params


@pytest.fixture(scope="module")
def femnist_setup():
    return _femnist_setup()


# A value within ~1e-9 of a rounding boundary quantises one step apart in
# the two packages; that step feeds the next rounds, and a one-step
# difference in the broadcast moves every client. One round is held within
# one step (``test_engine_round_from_reference_state_matches_reference``);
# whole runs carry the differences forward, and which pair drifts furthest
# depends on which values happen to land near a boundary. Limits after 3
# rounds on the worst element and the worst leaf mean, in steps, and on the
# losses: a third above the largest readings of
# ``python tests/test_torch_transport.py`` (17.9 steps, 1.00, 2.2e-5 over
# the f32 pairs; 32.4, 3.27, 8.1e-4 for int8 up with the adaptive downlink
# on a q8 store).
DRIFT_LIMITS = (24.0, 1.35, LOSS_RTOL)
DRIFT_LIMITS_INT8_ADAPTIVE_Q8 = (43.0, 4.35, 1.1e-3)

PAIRS = [(up, down, "f32")
         for up in ("none", "int8", "int8x2", "topk")
         for down in ("none", "int8", "topk", "adaptive")
         if (up, down) != ("none", "none")] + [("none", "adaptive", "q8"),
                                               ("int8", "adaptive", "q8")]


def _run_pair(setup, up, down, ref_store, rounds=3):
    """The reference trainer and the port's on the CPU, same seeds. Returns
    (port history, reference history, port ids, reference ids, port
    trainer, reference trainer, whether the injected runtime model's rng
    was left untouched)."""
    task, data, params = setup
    kw = dict(total_clients=16, clients_per_round=6, rounds=rounds, k0=4,
              eta0=0.3, batch_size=8, k_schedule="rounds", seed=0,
              aggregator="kernel", transport=up, downlink=down,
              downlink_ref=ref_store)
    rt_kw = dict(clients_per_round=6, heterogeneity=0.5, seed=1)
    jrt = JRuntime(task.model_size_mb, task.runtime, **rt_kw)
    jtr = JTrainer(lambda p, b: jsmall.task_loss(p, task, b),
                   jax.tree.map(jnp.asarray, params), data, JFed(**kw), jrt)
    jids = record_ids(jtr)
    jh = jtr.run(rounds)
    ttask = get_paper_task("femnist")
    rt = RuntimeModel(ttask.model_size_mb, ttask.runtime, **rt_kw)
    rng_before = rt._rng.bit_generator.state
    tr = FedAvgTrainer(lambda p, b: small.task_loss(p, ttask, b),
                       _torch(params), data, FedConfig(**kw), rt,
                       device="cpu")
    ids = record_ids(tr)
    h = tr.run(rounds)
    return (h, jh, ids, jids, tr, jtr,
            rt._rng.bit_generator.state == rng_before)


@pytest.mark.parametrize("up,down,ref_store", PAIRS)
def test_trainer_wire_path_matches_reference(femnist_setup, up, down,
                                             ref_store):
    rounds = 3
    h, jh, ids, jids, tr, jtr, rng_untouched = _run_pair(
        femnist_setup, up, down, ref_store, rounds)
    assert ids == jids and len(ids) == rounds
    assert h.rounds == jh.rounds and h.k == jh.k and h.eta == jh.eta
    assert h.sgd_steps == jh.sgd_steps
    assert h.wall_clock_s == jh.wall_clock_s
    assert h.uplink_mbit == jh.uplink_mbit
    assert h.downlink_mbit == jh.downlink_mbit
    # the trainer charged a copy: the injected model's draws are untouched
    assert rng_untouched
    limit = (DRIFT_LIMITS_INT8_ADAPTIVE_Q8
             if (up, down, ref_store) == ("int8", "adaptive", "q8")
             else DRIFT_LIMITS)
    np.testing.assert_allclose(h.train_loss, jh.train_loss, rtol=limit[2])
    worst, mean = drift_in_steps(tr.params, jtr.params, femnist_setup[2])
    assert worst <= limit[0] and mean <= limit[1], (worst, mean, limit)


ROUND_PAIRS = [("int8", "int8", "f32"), ("int8x2", "topk", "f32"),
               ("topk", "topk", "f32"), ("int8", "adaptive", "q8"),
               ("none", "adaptive", "f32"), ("topk", "int8x2", "q8")]


@pytest.mark.parametrize("up,down,ref_store", ROUND_PAIRS)
def test_engine_round_from_reference_state_matches_reference(
        femnist_setup, up, down, ref_store):
    """Each round of the port's engine, started from the reference engine's
    own state before that round (params, codec residuals, broadcast
    reference), against the reference's round. One round's ~1e-9 noise can
    only quantise a few values one step apart, so the bound is tight:
    one step of the round's movement, and a mean far below it."""
    from repro.core.engine import RoundEngine as JEngine
    task, data, params = femnist_setup
    ttask = get_paper_task("femnist")
    kw = dict(aggregator="kernel", transport=up, downlink=down,
              downlink_ref=ref_store)
    jeng = JEngine(lambda p, b: jsmall.task_loss(p, task, b), **kw)
    teng = RoundEngine(lambda p, b: small.task_loss(p, ttask, b),
                       device="cpu", **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jeng.init_transport_state(jp)
    jeng.init_downlink_state(jp)
    rng = np.random.default_rng(3)
    for r in range(3):
        bb = pipeline_bucket(rng, data)
        before = (_np(jp), jeng.transport_state, jeng.downlink_state)
        jp, jf, _, _ = jeng.run_bucket(jp, bb.batches, bb.weights,
                                       np.full(1, 0.3, np.float32),
                                       np.ones(1, bool), ())
        teng.transport_state = to_port_state(before[1])
        teng.downlink_state = to_port_state(before[2])
        tp, tf, _, _ = teng.run_bucket(
            _torch(before[0]), {k: v[0] for k, v in bb.batches.items()},
            bb.weights[0], 0.3, ())
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf)[0], **TOL)
        if down == "adaptive":
            assert int(teng.last_downlink_levels) == int(
                np.asarray(jeng.last_downlink_levels)[0])
        fg, fw, f0 = flat(tp), flat(jp), flat(before[0])
        for k in fw:
            step = float(np.max(np.abs(fw[k] - f0[k]))) / 127.0
            diff = np.abs(fg[k] - fw[k])
            assert diff.max() <= TOL["atol"] + step, (r, k, diff.max(), step)
            assert diff.mean() <= TOL["atol"] / 10 + step / 20, \
                (r, k, diff.mean(), step)


def pipeline_bucket(rng, data):
    from repro_torch.data import pipeline
    return pipeline.bucket_batches(rng, data, n_rounds=1, k=4,
                                   clients_per_round=6, batch_size=8)


@pytest.mark.parametrize("kw,match", [
    (dict(transport="int8", aggregator="median"), "linear aggregator"),
    (dict(transport="topk", aggregator="trimmed_mean"), "linear aggregator"),
    (dict(downlink_ref="q8"), "requires a downlink codec"),
])
def test_engine_refusals_match_reference(kw, match):
    from repro.core.engine import RoundEngine as JEngine
    loss_fn = lambda p, b: None
    with pytest.raises(ValueError, match=match):
        JEngine(loss_fn, **kw)
    with pytest.raises(ValueError, match=match):
        RoundEngine(loss_fn, device="cpu", **kw)


if __name__ == "__main__":
    # The readings the whole-run drift limits are set from: for each pair,
    # the worst element and worst leaf mean in steps, and the largest
    # relative loss difference.
    setup = _femnist_setup()
    for up, down, ref_store in PAIRS:
        h, jh, _, _, tr, jtr, _ = _run_pair(setup, up, down, ref_store)
        worst, mean = drift_in_steps(tr.params, jtr.params, setup[2])
        loss = np.max(np.abs(np.subtract(h.train_loss, jh.train_loss))
                      / np.abs(jh.train_loss))
        print(f"{up:7s} {down:9s} {ref_store:4s} worst {worst:8.3f} steps"
              f"  mean {mean:6.3f} steps  loss rel {loss:.3e}", flush=True)
