"""The port's public API against the reference's: ``ExperimentSpec``
(serialization, overrides, validation, error strings), the sweep helpers,
the plugin registries, ``build``'s refusals, and the launchers
(``launch.train``, ``launch.serve --checkpoint``, ``launch.quickstart``)."""
import contextlib
import io
import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import registries as jreg
from repro.api import spec as jspec
from repro.api import sweep as jsweep
from repro_torch.api import registries as treg
from repro_torch.api import spec as tspec
from repro_torch.api import sweep as tsweep
from test_torch_parity_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SPECS = sorted((ROOT / "examples" / "specs").glob("*.json"))
RUNS = ["adaptive-downlink", "fixed-cohort-topk", "local-int8-decayK",
        "local-int8-downlink"]
# spec -> (refused field, ROADMAP item); None: ported, the spec builds
REFUSED = {"population-chunked": None,                 # A6, streaming
           "async-buffered": None,                     # A7, async buffer
           "serve-while-training": None,               # A8, serving
           "mesh-sequential-cosine": None}             # A13 (a)


def _norm(msg: str) -> str:
    """The port names its own module where the reference names its."""
    return msg.replace("repro_torch.", "repro.")


def _outcome(mod, fn):
    """``("ok", value)`` or ``("error", type name, [messages])``."""
    try:
        return ("ok", fn(mod))
    except mod.SpecValidationError as e:
        return ("error", "SpecValidationError", [_norm(m) for m in e.errors])


def _same(fn):
    got, want = _outcome(tspec, fn), _outcome(jspec, fn)
    if got[0] == "ok" and want[0] == "ok":
        g, w = got[1], want[1]
        if isinstance(g, (tspec.ExperimentSpec,)):
            g, w = g.to_json(), w.to_json()
        assert g == w
    else:
        assert got == want
    return got


# ---------------------------------------------------------------------------
# spec
# ---------------------------------------------------------------------------

def test_every_example_spec_serializes_identically():
    assert len(SPECS) == 8
    for path in SPECS:
        t = tspec.ExperimentSpec.load(str(path))
        j = jspec.ExperimentSpec.load(str(path))
        assert t.to_json() == j.to_json(), path.name
        assert t.as_dict() == j.as_dict()
        assert tspec.ExperimentSpec.from_json(t.to_json()) == t
        t.validate()                 # every example validates in both
        j.validate()


def _nondefault(m):
    return m.ExperimentSpec().with_overrides(
        "data.kind=paper", "data.task=femnist", "data.clients=12",
        "fed.rounds=8", "fed.clients_per_round=4", "fed.k0=3",
        "fed.k_schedule=rounds", "fed.eta0=0.3", "fed.batch_size=4",
        "sampler.name=fixed_cohort", "sampler.cohort=[0,2,5,7]",
        "transport.name=int8", "backend.name=mesh",
        "backend.strategy=sequential", "runtime.beta_seconds=0.05")


def _unknown_keys(m):
    d = m.ExperimentSpec().as_dict()
    d["fed"]["warp_factor"] = 9
    d["mystery"] = {}
    return m.ExperimentSpec.from_dict(d)


# the cases of tests/test_api.py:43-133, and a few more of validate's rules
SPEC_CASES = {
    "nondefault-roundtrip": lambda m: m.ExperimentSpec.from_json(
        _nondefault(m).to_json()),
    "from-dict-unknown-keys": _unknown_keys,
    "overrides-types": lambda m: m.ExperimentSpec().with_overrides(
        "fed.k0=4", "fed.eta0=0.25", "fed.k_quantize=true",
        "transport.name=topk", "sampler.cohort=null"),
    "overrides-errors": lambda m: m.ExperimentSpec().with_overrides(
        "fed.nope=1", "bogus.k=2", "fed.k0=notanint", "fed.k0",
        "fed.k0.x=1"),
    "sweep-syntax-hint": lambda m: m.ExperimentSpec().with_overrides(
        "fed.k0=2,4"),
    "validate-aggregates": lambda m: m.ExperimentSpec().with_overrides(
        "fed.k_schedule=warp", "fed.aggregator=meen", "fed.rounds=0",
        "transport.topk_frac=7").validate(),
    "validate-linear-aggregator": lambda m: m.ExperimentSpec()
    .with_overrides("transport.name=int8", "fed.aggregator=median")
    .validate(),
    "validate-downlink-ok": lambda m: m.ExperimentSpec().with_overrides(
        "transport.downlink=int8", "fed.aggregator=median").validate(),
    "validate-downlink-unknown": lambda m: m.ExperimentSpec()
    .with_overrides("transport.downlink=int9").validate(),
    "validate-cohort-length": lambda m: m.ExperimentSpec().with_overrides(
        "sampler.name=fixed_cohort", "sampler.cohort=[1,2]",
        "fed.clients_per_round=4").validate(),
    "validate-async-knobs-under-sync": lambda m: m.ExperimentSpec()
    .with_overrides("fed.buffer_size=4", "fed.staleness_weight=poly",
                    "fed.max_staleness=2").validate(),
    "validate-async-rules": lambda m: m.ExperimentSpec().with_overrides(
        "fed.aggregation=async", "fed.aggregator=median",
        "transport.downlink=int8", "fed.buffer_size=99",
        "fed.staleness_weight=invv").validate(),
    "validate-serve": lambda m: m.ExperimentSpec().with_overrides(
        "serve.qps=900", "serve.traffic=bursty", "data.kind=paper",
        "data.task=femnist", "serve.every=0").validate(),
    "validate-later-arch": lambda m: m.ExperimentSpec().with_overrides(
        "model.arch=whisper-tiny").validate(),
    "validate-unknown-arch": lambda m: m.ExperimentSpec().with_overrides(
        "model.arch=gpt5").validate(),
    "validate-chunk-rules": lambda m: m.ExperimentSpec().with_overrides(
        "fed.cohort_chunk=0", "fed.aggregator=median",
        "transport.downlink=int8", "backend.name=mesh",
        "backend.strategy=sequential").validate(),
    "validate-adaptive-uplink": lambda m: m.ExperimentSpec().with_overrides(
        "transport.name=adaptive", "transport.ref_store=q8").validate(),
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_cases_match_reference(case):
    """``with_overrides``, ``validate`` and ``from_dict`` give the same
    values, and the same error lists (messages and order), in both
    packages."""
    out = _same(SPEC_CASES[case])
    want_error = case not in ("nondefault-roundtrip", "overrides-types",
                              "validate-downlink-ok", "validate-later-arch")
    assert (out[0] == "error") == want_error, out


def test_spec_file_roundtrip_loads_in_the_other_package(tmp_path):
    path = str(tmp_path / "spec.json")
    _nondefault(tspec).save(path)
    assert jspec.ExperimentSpec.load(path) == _nondefault(jspec)
    assert tspec.ExperimentSpec.load(path) == _nondefault(tspec)


# ---------------------------------------------------------------------------
# sweep
# ---------------------------------------------------------------------------

SWEEPS = [("fed.k0=2,4,8",), ("fed.k0=2,4", "transport.name=int8,topk"),
          ("sampler.cohort=[0,1]",), ("fed.k0=4",),
          ("fed.k0=2,notanint", "fed.bogus=1,2"), ("nodots",),
          ("fed.k0=2,,4",), ("fed.clients_per_round=4,99",)]


@pytest.mark.parametrize("grid", SWEEPS, ids=["|".join(g) for g in SWEEPS])
def test_sweep_helpers_match_reference(grid):
    for fn in (lambda m: m.parse_sweep(grid), lambda m: m.sweep_grid(grid)):
        t, j = _outcome_sweep(tsweep, fn), _outcome_sweep(jsweep, fn)
        assert t == j
    t = _outcome_sweep(tsweep, lambda m: [
        (p.label, p.overrides, p.spec.to_json(), m.spec_program_key(p.spec))
        for p in m.expand_sweep(*grid)])
    j = _outcome_sweep(jsweep, lambda m: [
        (p.label, p.overrides, p.spec.to_json(), m.spec_program_key(p.spec))
        for p in m.expand_sweep(*grid)])
    assert t == j


def _outcome_sweep(mod, fn):
    try:
        return ("ok", fn(mod))
    except mod.SpecValidationError as e:
        return ("error", [_norm(m) for m in e.errors])


@pytest.mark.parametrize("path", SPECS, ids=[p.stem for p in SPECS])
def test_program_key_matches_reference(path):
    assert tsweep.spec_program_key(tspec.ExperimentSpec.load(str(path))) \
        == jsweep.spec_program_key(jspec.ExperimentSpec.load(str(path)))


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_registries_hold_the_reference_names():
    assert sorted(treg.REGISTRIES) == sorted(jreg.REGISTRIES)
    for kind, reg in treg.REGISTRIES.items():
        assert reg.available() == jreg.REGISTRIES[kind].available(), kind
        assert repr(reg) == repr(jreg.REGISTRIES[kind])
    for name in treg.STALENESS_WEIGHT_REGISTRY.available():
        got = treg.STALENESS_WEIGHT_REGISTRY.get(name)()
        want = jreg.STALENESS_WEIGHT_REGISTRY.get(name)()
        assert [got(st) for st in range(6)] == [want(st) for st in range(6)]
    # the async factory builds the buffered engine (ROADMAP A7)
    from repro_torch.configs import FedConfig, get_paper_task
    from repro_torch.core import RuntimeModel
    from repro_torch.core.engine import AsyncBufferedEngine
    from repro_torch.data import make_paper_task
    from repro_torch.models import small
    task = get_paper_task("femnist")
    engine = treg.AGGREGATION_REGISTRY.get("async")()(
        lambda p, b: small.task_loss(p, task, b),
        small.init_task_model(0, task, device="cpu"),
        make_paper_task("femnist", np.random.default_rng(0), num_clients=4,
                        samples_per_client=4),
        FedConfig(clients_per_round=2, aggregation="async"),
        RuntimeModel(1.0, task.runtime, 2), device="cpu")
    assert type(engine) is AsyncBufferedEngine and engine.buffer_size == 2


MISSPELT = {"aggregator": "meen", "server_optimizer": "fedadamw",
            "transport": "int4", "sampler": "fixed_cohrt",
            "backend": "tpu-pod", "aggregation": "asink",
            "staleness_weight": "polyy", "traffic": "synthetc"}


@pytest.mark.parametrize("kind", sorted(MISSPELT))
def test_unknown_names_give_the_reference_message(kind):
    name = MISSPELT[kind]
    with pytest.raises(jreg.UnknownNameError) as want:
        jreg.REGISTRIES[kind].get(name)
    with pytest.raises(treg.UnknownNameError) as got:
        treg.REGISTRIES[kind].get(name)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, KeyError) and isinstance(got.value,
                                                          ValueError)


def test_engine_lookups_resolve_through_the_registries():
    from repro_torch.core.engine import aggregators, sampling, server
    from repro_torch.core.engine import transport as tt
    from repro_torch.core.engine.backends import get_backend
    with pytest.raises(KeyError, match="Did you mean 'mean'"):
        aggregators.get_aggregator("meen")
    with pytest.raises(KeyError, match="Did you mean 'fedadam'"):
        server.get_server_optimizer("fedadm")
    with pytest.raises(KeyError, match="Did you mean 'uniform'"):
        sampling.get_sampler("unifrm")
    with pytest.raises(KeyError, match="Available: local, mesh"):
        get_backend("tpu-pod")
    with pytest.raises(ValueError, match="downlink-only"):
        tt.get_transport("adaptive")
    # top-k registers its error-feedback form only
    assert tt.get_transport("topk", topk_frac=0.3).error_feedback
    assert tt.get_downlink("adaptive", ref_store="q8").ref_store == "q8"


def test_registered_custom_aggregator_resolves_through_build():
    from repro_torch.api import build
    from repro_torch.core.engine.aggregators import weighted_mean
    from repro_torch.optim import tree_map
    name = "test_torch_double_mean"
    calls = []

    def factory(**kw):
        def agg(cp, w):
            calls.append(1)
            return tree_map(lambda x: 2.0 * x, weighted_mean(cp, w))
        return agg

    treg.register_aggregator(name, factory)
    try:
        spec = tspec.ExperimentSpec().with_overrides(
            "data.kind=paper", "data.task=sent140", "data.clients=6",
            "data.samples_per_client=8", "fed.clients_per_round=3",
            "fed.k0=2", "fed.batch_size=4", "fed.rounds=2",
            f"fed.aggregator={name}")
        exp = build(spec, device="cpu")
        h = exp.run()
        assert calls == [1, 1] and h.rounds == [1, 2]
        assert name in treg.AGGREGATOR_REGISTRY.available()
    finally:
        treg.AGGREGATOR_REGISTRY._entries.pop(name, None)


# ---------------------------------------------------------------------------
# build: runs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(REFUSED))
def test_build_refuses_unported_specs_by_name(name, tmp_path):
    """Each spec validates (as in the reference). ``build`` refuses a spec
    the port cannot run yet, naming the field and the ROADMAP item; the
    streaming (A6), async (A7), serve-while-training (A8) and mesh
    sequential (A13 (a), on a one-rank gloo group) specs build and run a
    round."""
    import torch.distributed as dist
    from repro_torch.api import build
    from repro_torch.core.engine import AsyncBufferedEngine, FedAvgTrainer
    spec = tspec.ExperimentSpec.load(str(ROOT / "examples" / "specs"
                                         / f"{name}.json"))
    spec.validate()
    if REFUSED[name] is None:
        mesh = spec.backend.name == "mesh"
        if mesh:
            dist.init_process_group("gloo", rank=0, world_size=1,
                                    init_method=f"file://{tmp_path}/pg")
        try:
            exp = build(spec, device="cpu")
            want = (AsyncBufferedEngine if spec.fed.aggregation == "async"
                    else FedAvgTrainer)
            assert type(exp.trainer) is want
            h = exp.run(1)
        finally:
            if mesh:
                dist.destroy_process_group()
        assert h.rounds == [1] and np.isfinite(h.train_loss).all()
        return
    field, item = REFUSED[name]
    with pytest.raises(ValueError, match=rf"{field}=.*ROADMAP {item}\b"):
        build(spec, device="cpu")


def test_build_refuses_later_archs_by_name():
    """``model.arch=whisper-tiny`` over LM data: both packages' ``build``
    runs, and the first round raises ``KeyError: 'audio_embeds'`` in both
    (the LM clients carry no audio; the port adds none)."""
    from repro.api import build as jbuild
    from repro_torch.api import build
    overrides = ("model.arch=whisper-tiny", "fed.rounds=1")
    outcomes = []
    for exp in (build(tspec.ExperimentSpec().with_overrides(*overrides),
                      device="cpu"),
                jbuild(jspec.ExperimentSpec().with_overrides(*overrides))):
        assert exp.label == "whisper-tiny-reduced"
        with pytest.raises(KeyError) as e:
            exp.run(1)
        outcomes.append(e.value.args)
    assert outcomes[0] == outcomes[1] == ("audio_embeds",)


def test_restore_needs_an_embedded_spec(tmp_path):
    from repro_torch.api import FederatedExperiment
    from repro_torch.checkpoint import save_checkpoint
    path = str(tmp_path / "bare")
    save_checkpoint(path, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="no embedded spec"):
        FederatedExperiment.restore(path, device="cpu")


def _run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def _resolved(text: str) -> str:
    lines = text.splitlines()
    i = lines.index("[train] resolved spec:")
    j = next(k for k in range(i + 1, len(lines))
             if lines[k].startswith("[train]"))
    return "\n".join(lines[i + 1:j])


# the LM specs at a smaller step (the traffic's shape kept): time
LM_SMALL = ["--set", "data.seq_len=16", "--set", "fed.batch_size=2",
            "--set", "fed.k0=2"]


@pytest.mark.parametrize("name", RUNS)
def test_launcher_runs_the_local_lm_specs(tmp_path, name):
    """``python -m repro_torch.launch.train --spec <s> --device cpu`` runs
    each local-backend LM spec (at seq 16, b 2, k0 2) and saves a
    checkpoint with the spec embedded, which
    ``FederatedExperiment.restore`` rebuilds."""
    from repro_torch.api import FederatedExperiment
    from repro_torch.launch import train
    ckpt = str(tmp_path / "ckpt")
    exp, out = _run_main(train.main, [
        "--spec", str(ROOT / "examples" / "specs" / f"{name}.json"),
        "--rounds", "2", "--device", "cpu", "--checkpoint", ckpt, *LM_SMALL])
    assert exp.history.rounds == [1, 2]
    assert exp.spec.transport == tspec.ExperimentSpec.load(
        str(ROOT / "examples" / "specs" / f"{name}.json")).transport
    # K stays 2: one bucket of both rounds, one program (the reference's
    # counts for these runs)
    assert ("[train] engine[local]: 1 bucket program(s) built, 1 "
            "dispatch(es) for 2 rounds (cpu)") in out
    assert f"[train] checkpoint (spec embedded) -> {ckpt}" in out
    again = FederatedExperiment.restore(ckpt, device="cpu")
    assert again.spec == exp.spec
    assert again.history.as_dict() == exp.history.as_dict()


class _Stop(Exception):
    pass


def test_launcher_prints_the_reference_resolved_spec(monkeypatch):
    """The same argv gives the same resolved spec text in both launchers
    (the port's run included; the reference's main is stopped at its
    ``build``, after it printed the spec); the legacy flags translate
    alike."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    argv = ["--spec", str(ROOT / "examples" / "specs"
                          / "local-int8-decayK.json"),
            "--rounds", "1", "--set", "sampler.name=weighted", *LM_SMALL]
    _, out = _run_main(train.main, argv + ["--device", "cpu"])

    def stop(spec, *a, **kw):
        raise _Stop

    monkeypatch.setattr(jtrain, "build", stop)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout), pytest.raises(_Stop):
        jtrain.main(argv)
    assert ("[train] engine[local]: 1 bucket program(s) built, 1 "
            "dispatch(es) for 1 rounds (cpu)") in out
    assert _resolved(out) == _resolved(jout.getvalue() + "[train] end")
    for legacy in ([], ["--arch", "qwen2-7b", "--rounds", "7", "--transport",
                        "topk", "--downlink", "adaptive", "--ref-store", "q8",
                        "--sampler", "fixed_cohort", "--aggregation",
                        "async", "--buffer-size", "3", "--max-staleness",
                        "2", "--serve-every", "2", "--serve-qps", "5"]):
        got = train.resolve_spec(train.make_parser().parse_args(legacy))
        want = jtrain.resolve_spec(jtrain.make_parser().parse_args(legacy))
        assert got.to_json() == want.to_json()


FLEET_SMALL = ["--set", "data.kind=paper", "--set", "data.task=femnist",
               "--set", "data.clients=8", "--set", "data.samples_per_client=8",
               "--set", "fed.clients_per_round=4", "--set", "fed.batch_size=4",
               "--set", "fed.k_schedule=fixed", "--rounds", "2"]


def test_launcher_refuses_a_sweep():
    """A bad sweep grid is refused before any point runs, naming the axis,
    as the reference's launcher does; a good one runs as a fleet."""
    from repro.api import spec as jspec
    from repro.launch import train as jtrain
    from repro_torch.launch import train
    for main, error, extra in (
            (jtrain.main, jspec.SpecValidationError, []),
            (train.main, tspec.SpecValidationError, ["--device", "cpu"])):
        with pytest.raises(error, match="fed.nope"):
            main(["--sweep", "fed.nope=2,4", *extra])
    res, out = _run_main(train.main, ["--sweep", "fed.k0=2,4", "--device",
                                      "cpu", *FLEET_SMALL])
    assert [p.label for p in res.points] == ["k0=2", "k0=4"]
    assert "fleet: 2 point(s)" in out


@pytest.mark.parametrize("flags", [["--sweep-csv", "fleet.csv"],
                                   ["--share-k-grid"], ["--serial-sweep"]])
def test_launcher_refuses_sweep_only_flags(flags, tmp_path):
    """The flags only a sweep reads act on the sweep they come with (the
    CSV written, the k0 points sharing one program, the points run one
    after another), as the reference's."""
    from repro_torch.launch import train
    if flags[0] == "--sweep-csv":
        flags = [flags[0], str(tmp_path / flags[1])]
    res, out = _run_main(train.main, ["--sweep", "fed.k0=3,4", *flags,
                                      "--device", "cpu", *FLEET_SMALL])
    if flags[0] == "--sweep-csv":
        assert os.path.exists(flags[1])
        assert f"[train] fleet csv -> {flags[1]}" in out
    assert res.packed == (flags[0] != "--serial-sweep")
    assert res.shared_count == (1 if flags[0] == "--share-k-grid" else 0)


# ---------------------------------------------------------------------------
# serving from a checkpoint
# ---------------------------------------------------------------------------

def test_serve_decodes_a_port_checkpoint_bitwise(tmp_path):
    """``launch.serve --checkpoint`` rebuilds the model from the embedded
    spec and serves exactly the checkpoint's params; a conflicting
    ``--arch`` errors; a checkpoint without a spec takes ``--arch``."""
    from repro_torch.api import build
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch import serve
    spec = tspec.ExperimentSpec.load(
        str(ROOT / "examples" / "specs" / "local-int8-downlink.json")
    ).with_overrides("fed.rounds=1", *LM_SMALL[1::2])
    exp = build(spec, device="cpu")
    exp.run()
    ckpt = str(tmp_path / "ckpt")
    exp.save(ckpt)
    res, out = _run_main(serve.main, ["--checkpoint", ckpt, "--device",
                                      "cpu", "--tokens", "4"])
    assert "from the checkpoint's embedded spec, round 1" in out
    assert res["cfg"].name == "qwen1.5-0.5b-reduced"
    with np.load(os.path.join(ckpt, "arrays.npz")) as data:
        from test_torch_parity_helpers import flat
        served = flat(res["params"])
        assert sorted(served) == sorted(
            k[len("params/"):] + "/" for k in data if k.startswith("params/"))
        for k, v in served.items():
            np.testing.assert_array_equal(v, data["params/" + k[:-1]])
    assert res["ids"].shape == (4, 4)
    with pytest.raises(SystemExit, match="conflicts"):
        serve.main(["--checkpoint", ckpt, "--arch", "gemma2-27b",
                    "--device", "cpu"])
    bare = str(tmp_path / "bare")
    save_checkpoint(bare, exp.params)
    res, out = _run_main(serve.main, ["--checkpoint", bare, "--arch",
                                      "qwen1.5-0.5b", "--device", "cpu",
                                      "--tokens", "2"])
    assert "without an embedded spec" in out
    assert res["cfg"].name == "qwen1.5-0.5b-reduced"
    with pytest.raises(SystemExit, match="checkpoint"):
        serve.main(["--checkpoint", str(tmp_path / "none"), "--device",
                    "cpu"])


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

def test_quickstart_matches_the_reference_example(monkeypatch):
    """``launch.quickstart --rounds 6 --clients 10`` against
    ``examples/quickstart.py`` with the same flags: K_r, sgd_steps and the
    simulated wall clock of both schedules exactly equal."""
    from repro.core.engine import trainer as jtrainer
    from repro_torch.launch import quickstart
    histories = []
    run = jtrainer.FedAvgTrainer.run

    def recording_run(self, *a, **kw):
        histories.append(run(self, *a, **kw))
        return histories[-1]

    monkeypatch.setattr(jtrainer.FedAvgTrainer, "run", recording_run)
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--rounds", "6",
                                      "--clients", "10"])
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                       run_name="__main__")
    got, out = _run_main(quickstart.main, ["--rounds", "6", "--clients",
                                           "10", "--device", "cpu"])
    assert "(6 dispatch(es) for 6 rounds)" in out
    assert len(histories) == 2
    for h, jh in zip((got["fixed"], got["rounds"]), histories):
        assert h.k == jh.k and h.sgd_steps == jh.sgd_steps
        assert h.wall_clock_s == jh.wall_clock_s
        assert h.rounds == jh.rounds == list(range(1, 7))
    assert got["fixed"].k == [16] * 6 and got["rounds"].k[0] == 16
