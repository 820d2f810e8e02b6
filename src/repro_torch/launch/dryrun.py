"""Dry run: the per-device accounting of every (architecture x input shape
x production mesh) case, on the ``meta`` device, with nothing compiled
(the port of ``repro/launch/dryrun.py``).

For each case of the reference's ``all_cases`` this takes the reference's
choices of ``build_case`` (strategy, 2d params, FSDP axes, client count,
local steps, batch, input and cache specs) and sums the bytes one device
holds under the sharding rules (``distributed.sharding``):

* train cases: the params (bf16), the round's batches, the client weights
  and eta, as the arguments of one federated train step;
* prefill cases: the params, the inputs, and the decode states the
  prefill returns (``cache_pspecs``) beside its last-token logits;
* decode cases: the params, the cache (``cache_specs``, ``cache_pspecs``),
  the token batch and the position.

What the reference also records reads XLA's compiled program: its memory
and cost analysis and ``hlo_analysis.py``/``hlo_loops.py`` (collectives,
trip counts, roofline terms). The port compiles nothing, so those have no
analogue here. Nothing is written under ``experiments/dryrun/``, which
holds the reference's records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.distributed import sharding
from repro_torch.distributed.strategies import (fed_batch_specs,
                                                fed_weight_specs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import registry
from repro_torch.models.registry import TensorSpec

# the dry run's federated round geometry (the reference's K_LOCAL)
K_LOCAL = 4

# archs on strategy B (sequential) and 2d params (the reference's list)
SEQUENTIAL_ARCHS = {"gemma2-27b", "phi3.5-moe-42b-a6.6b", "llava-next-34b",
                    "mixtral-8x22b", "nemotron-4-340b"}

DTYPE = torch.bfloat16


def should_skip(cfg, shape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("pure full-attention arch: long_500k requires sub-quadratic "
                "attention")
    return None


def case_name(arch: str, shape: str, multi_pod: bool) -> str:
    return f"{arch}__{shape}__{'2x16x16' if multi_pod else '16x16'}"


def all_cases() -> Iterator[Tuple[str, str, bool]]:
    for arch in ARCHS:
        for shape in SHAPES:
            for multi_pod in (False, True):
                yield arch, shape, multi_pod


def case_plan(arch_name: str, shape_name: str, multi_pod: bool,
              mesh=None) -> Dict[str, Any]:
    """The case's choices and, for each argument group (``"params"``,
    ``"batches"``, ...), its leaves (with ``shape`` and ``dtype``) and
    their specs, two trees alike, as the reference's ``build_case`` makes
    them without overrides. ``mesh``: the production mesh (None), or
    another (a ``MeshShape`` or a DeviceMesh) whose ranks hold the same
    layouts at its sizes."""
    cfg, shape = get_arch(arch_name), get_shape(shape_name)
    mesh = (make_production_mesh(multi_pod=multi_pod) if mesh is None
            else sharding.MeshShape.of(mesh))
    two_d = cfg.name in SEQUENTIAL_ARCHS
    strategy = "sequential" if two_d else "parallel"
    fsdp_axes = ("data", "pod") if (two_d and multi_pod) else ("data",)
    p_shapes = registry.shapes(cfg, DTYPE)
    pspecs = sharding.param_pspecs(cfg, p_shapes, mesh, two_d=two_d,
                                   fsdp_axes=fsdp_axes)
    plan: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "devices": mesh.size,
        "strategy": strategy, "two_d_params": two_d,
        "fsdp_axes": list(fsdp_axes),
        "param_count": registry.param_count(cfg),
        "groups": {"params": (p_shapes, pspecs)},
    }
    ba = sharding.serve_batch_axes(mesh)
    ba_size = sharding.entry_size(mesh, ba)
    B = shape.global_batch
    b_ax = ba if B % ba_size == 0 else None
    model = mesh.shape["model"]
    i32 = torch.int32

    if shape.kind == "train":
        n_clients = 32 if (multi_pod and strategy == "parallel") else 16
        groups = 1 if strategy == "sequential" else None
        k_local = K_LOCAL
        batches = fed_batch_specs(cfg, shape, n_clients=n_clients,
                                  k_local=k_local, groups=groups, dtype=DTYPE)
        weights = fed_weight_specs(n_clients, groups)
        b_specs = sharding.fed_batch_pspecs(batches, mesh, strategy)
        w_spec = (sharding.PSpec(sharding.client_axes(mesh))
                  if strategy == "parallel" else sharding.PSpec(None, None))
        plan["groups"].update(
            batches=(batches, b_specs), weights=(weights, w_spec),
            eta=(TensorSpec((), torch.float32), sharding.PSpec()))
        plan.update(n_clients=n_clients, k_local=k_local,
                    groups_count=groups or 0,
                    tokens_per_round=B * shape.seq_len * k_local)
        return plan

    logit_spec = sharding.PSpec(b_ax, "model" if cfg.vocab_size % model == 0
                                else None)
    if shape.kind == "prefill":
        inputs = registry.input_specs(cfg, shape, dtype=DTYPE)
        plan["groups"]["inputs"] = (inputs, {
            k: sharding.PSpec(b_ax, *(None,) * (len(v.shape) - 1))
            for k, v in inputs.items()})
        if not registry.is_encdec(cfg):
            # the prefill's decode states: the full-length cache's shapes
            states = registry.cache_specs(cfg, B, shape.seq_len, DTYPE)
            plan["groups"]["states"] = (
                states, sharding.cache_pspecs(cfg, states, mesh))
            plan["groups"]["logits"] = (
                TensorSpec((B, cfg.vocab_size), DTYPE), logit_spec)
        plan.update(tokens=B * shape.seq_len)
        return plan

    long_mode = shape.name == "long_500k"
    cache = registry.cache_specs(cfg, B, shape.seq_len, DTYPE,
                                 long_mode=long_mode)
    plan["groups"].update(
        cache=(cache, sharding.cache_pspecs(cfg, cache, mesh)),
        token=(TensorSpec((B,), i32), sharding.PSpec(b_ax)),
        pos=(TensorSpec((), i32), sharding.PSpec()))
    plan.update(tokens=B)
    return plan


def run_case(arch_name: str, shape_name: str,
             multi_pod: bool) -> Dict[str, Any]:
    """One case's record: its choices, and the bytes a device holds of each
    argument group, of the arguments together (``argument_bytes``, the
    reference's ``argument_size_in_bytes``) and of the outputs (a train
    step's params and loss; a prefill's states and logits)."""
    cfg, shape = get_arch(arch_name), get_shape(shape_name)
    record: Dict[str, Any] = {
        "case": case_name(arch_name, shape_name, multi_pod),
        "arch": arch_name, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16"}
    skip = should_skip(cfg, shape)
    if skip:
        record.update(status="skipped", reason=skip)
        return record
    plan = case_plan(arch_name, shape_name, multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    groups = plan.pop("groups")
    per_device = {name: sharding.block_bytes(leaves, specs, mesh)
                  for name, (leaves, specs) in groups.items()}
    outputs = ("states", "logits")
    record.update(plan)
    record.update(
        status="ok", bytes_per_device=per_device,
        argument_bytes=sum(v for k, v in per_device.items()
                           if k not in outputs),
        # a train step returns the params and the mean loss (f32)
        output_bytes=(per_device["params"] + 4 if shape.kind == "train"
                      else sum(per_device.get(k, 0) for k in outputs)))
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape x mesh) case")
    args = ap.parse_args(argv)
    if args.all:
        cases = list(all_cases())
    elif args.arch and args.shape:
        cases = [(args.arch, args.shape, args.multi_pod)]
    else:
        ap.error("--arch and --shape required (or --all)")
    for arch, shape, mp in cases:
        rec = run_case(arch, shape, mp)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
