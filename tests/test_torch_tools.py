"""The port's rollout tools and host tools against the JAX package's.

  * The five rollout tools write the JAX tools' files with the JAX tools'
    keys. Their draws differ by design, so the numbers are held where
    both packages compute the same thing: ``probe_tau_stability`` at
    tau = 0 on shared weights (a JAX Orbax checkpoint carried to the port
    by ``tools/export_to_torch.py``; max|y| is rounded to 2 decimals by
    both, so within one rounding step); ``probe_spectrum`` and
    ``sweep_temperature`` with each package's rollout factory
    monkeypatched to the same arrays (as ``test_torch_evaluate.py`` does),
    every column within 1e-4 relative (1e-6 absolute near 0): the
    spectrum probe's whole tau grid, the temperature sweep at tau = 0.3
    and 0.7 (at tau = 0 its spread fits divide by a zero spread);
    ``probe_width``'s parameter counts equal JAX's; the rates of
    ``sweep_members`` and ``probe_width`` are host timings and only
    positive. ``sweep_temperature``'s figure is drawn. Without
    ``--device`` each new entry point asks for the GPU.
  * ``report`` and ``compare_runs``: the same markdown (its "Generated"
    timestamp line masked), table and JSON as JAX's on the same files,
    the committed ``runs/r5_eval_oracle/backward-step/eval_metrics.json``
    among them.
  * ``inspect_checkpoint``: a sound trainer file, an exporter's file, a
    drifted one, a non-finite one, a truncated one, and a path that is
    missing and stays missing.
  * ``doctor``: the subprocess runner (last line, failure, timeout), a
    failed WARN-only check that keeps the exit code 0, and a real run of
    its checks here.
"""

import dataclasses
import json
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import CASE, TINY, shared_checkpoints

import tpuflow.eval.loading as j_loading
import tpuflow.eval.rollout as j_rollout_mod
import tpuflow.tools.compare_runs as j_compare
import tpuflow.tools.report as j_report
import tpuflow.tools.probe_spectrum as j_probe_spectrum
from tpuflow.tools.probe_tau_stability import main as j_probe_tau
from tpuflow.tools.probe_width import main as j_probe_width
from tpuflow.tools.sweep_members import main as j_sweep_members
from tpuflow.tools.sweep_temperature import main as j_sweep_temperature
from tpuflow_torch.configs import load_case, parse_cli_overrides
from tpuflow_torch.models import TMGlow
from tpuflow_torch.tools import (
    compare_runs,
    doctor,
    inspect_checkpoint,
    probe_spectrum,
    probe_tau_stability,
    probe_width,
    report,
    sweep_members,
    sweep_temperature,
)
from tpuflow_torch.train import Checkpointer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE = ROOT / "runs" / "r5_eval_oracle" / CASE
RTOL, ATOL = 1e-4, 1e-6
CPU = ["--device", "cpu"]


def _close(got, want, path=""):
    """Every leaf of two JSON rows equal (strings, bools, ints) or within
    RTOL / ATOL (floats)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=ATOL), path
    else:
        assert got == want, path


# ------------------------------------------------------------ the rollout tools


def test_sweep_members_and_probe_width_keep_jax_rows(tmp_path):
    # One flow step of one coupling layer per scale: JAX compiles a rollout
    # per width here.
    shallow = [*TINY, "model.n_flow_steps=1", "model.coupling_layers=1"]
    args = [CASE, "members=2", "steps=2", "repeats=1", *shallow]
    want = j_sweep_members([*args, f"eval.output_dir={tmp_path}/jax"])
    got = sweep_members.main([*args, f"eval.output_dir={tmp_path}/port", *CPU])
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [r["members"] for r in got] == [2] and got[0]["steps_per_sec"] > 0
    for d in ("jax", "port"):
        assert (tmp_path / d / CASE / "members_sweep.json").exists()
    saved = json.loads((tmp_path / "port" / CASE / "members_sweep.json").read_text())
    assert saved == got

    tiny = [a for a in shallow if not a.startswith(("model.coupling_width", "eval."))]
    want = j_probe_width([CASE, "steps=2", "samples=2", "widths=8", *tiny])
    got = probe_width.main([CASE, "steps=2", "samples=2", "widths=8,16", *tiny, *CPU])
    assert sorted(got[0]) == sorted(want[0])
    for k in ("case", "coupling_width", "n_params", "rollout_steps", "n_samples",
              "temperature"):
        assert got[0][k] == want[0][k], k
    assert got[0]["backend"] == "cpu" and got[0]["rollout_steps_per_sec"] > 0
    assert got[1]["n_params"] > got[0]["n_params"]


def test_probe_tau_stability_matches_jax_at_tau_zero(tmp_path):
    jdir, pdir = shared_checkpoints(tmp_path, TINY)
    args = [CASE, "taus=0.0", "clips=0,3", "seeds=1", *TINY, "eval.n_samples=2",
            "eval.rollout_steps=4"]
    want = j_probe_tau([*args, f"train.checkpoint_dir={jdir}"])
    got = probe_tau_stability.main([*args, f"train.checkpoint_dir={pdir}", *CPU])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("z_clip", "temperature", "seed", "first_nonfinite_step"):
            assert g[k] == w[k], k
        assert g["first_nonfinite_step"] == -1
        for k in ("max_abs_head", "max_abs_tail"):
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=0.01 + 1e-6)


H, W, C, T_MAX, N = 16, 32, 3, 8, 3
_rng = np.random.default_rng(5)
BASE_MEAN = (0.3 * _rng.standard_normal((H, W, C))).astype(np.float32)
BASE_VAR = (0.05 * np.exp(0.5 * _rng.standard_normal((H, W, C)))).astype(np.float32)
NOISE = _rng.standard_normal((T_MAX, N, H, W, C)).astype(np.float32)


def _fake_rollouts(monkeypatch, port_tool):
    """Both packages' rollout factories give the same function of the LF
    input and tau (the mean of a per-scale tau): stats mean = up(lf) +
    BASE_MEAN, var = tau^2 BASE_VAR (1 + up^2); fields = up(lf) + BASE_MEAN
    + tau NOISE. The checkpoint loaders return no weights (the train
    split's normalization)."""

    def j_factory(model, n_samples, temperature=1.0, collect="stats", **kw):
        def run(variables, lf, key, tau=temperature):
            up = jnp.repeat(jnp.repeat(lf, 4, axis=1), 4, axis=2)
            t = jnp.mean(jnp.atleast_1d(jnp.asarray(tau, jnp.float32)))
            if collect == "fields":
                return up[:, None] + BASE_MEAN + t * NOISE[: lf.shape[0], :n_samples]
            return {"mean": up + BASE_MEAN, "var": (t * t) * BASE_VAR * (1.0 + up**2)}
        return run

    def t_factory(model, n_samples, temperature=1.0, collect="stats", **kw):
        def run(lf, generator=None, tau=temperature):
            up = lf.repeat_interleave(4, dim=1).repeat_interleave(4, dim=2)
            t = torch.as_tensor(tau, dtype=torch.float32).reshape(-1).mean()
            if collect == "fields":
                return up[:, None] + torch.from_numpy(BASE_MEAN) + t * torch.from_numpy(
                    NOISE[: lf.shape[0], :n_samples])
            return {"mean": up + torch.from_numpy(BASE_MEAN),
                    "var": (t * t) * torch.from_numpy(BASE_VAR) * (1.0 + up**2)}
        return run

    monkeypatch.setattr(j_rollout_mod, "make_ensemble_rollout", j_factory)
    monkeypatch.setattr(j_loading, "load_eval_bundle", lambda cfg, *a: (None, None, None, {}))
    monkeypatch.setattr(port_tool, "make_ensemble_rollout", t_factory)
    monkeypatch.setattr(port_tool, "load_eval_bundle", lambda cfg, device: (
        types.SimpleNamespace(device=torch.device("cpu")), None, {}))


SAMPLES = [*TINY, "data.n_test_traj=2", "data.train_steps=8", "eval.n_samples=3",
           "eval.rollout_steps=8", "eval.calibration_steps=4", "eval.ref_steps=12"]


def test_probe_spectrum_matches_jax_on_the_same_members(monkeypatch, tmp_path):
    _fake_rollouts(monkeypatch, probe_spectrum)
    # 3 members over a 6-step window (the tools' defaults: 8 over 32).
    t_run, j_run = probe_spectrum.run_probe, j_probe_spectrum.run_probe
    monkeypatch.setattr(probe_spectrum, "run_probe",
                        lambda cfg, device="cuda": t_run(cfg, 3, 6, device))
    monkeypatch.setattr(j_probe_spectrum, "run_probe", lambda cfg: j_run(cfg, 3, 6))
    args = [CASE, *SAMPLES]
    want = j_probe_spectrum.main([*args, f"eval.output_dir={tmp_path}/jax"])
    got = probe_spectrum.main([*args, f"eval.output_dir={tmp_path}/port", *CPU])
    assert [r["setting"] for r in got] == [r["setting"] for r in want]
    assert len(got) == 2 + 2 * 2 + 1
    _close(got, want)
    saved = json.loads((tmp_path / "port" / CASE / "spectrum_probe.json").read_text())
    assert saved == got and (tmp_path / "jax" / CASE / "spectrum_probe.json").exists()


def test_sweep_temperature_matches_jax_and_draws_its_figure(monkeypatch, tmp_path):
    _fake_rollouts(monkeypatch, sweep_temperature)
    args = [CASE, "temperatures=0.3,0.7", *SAMPLES]
    want = j_sweep_temperature([*args, f"eval.output_dir={tmp_path}/jax"])
    got = sweep_temperature.main([*args, f"eval.output_dir={tmp_path}/port", *CPU])
    assert [r["temperature"] for r in got] == [0.3, 0.7]
    assert "pdf_w1_u" in got[1] and got[1]["calibration_in_sample"] is False
    _close(got, want)
    names = {d: sorted(p.name for p in (tmp_path / d / CASE).iterdir()) for d in ("jax", "port")}
    assert names["port"] == names["jax"] == ["temperature_sweep.json", "temperature_sweep.png"]
    assert json.loads((tmp_path / "port" / CASE / "temperature_sweep.json").read_text()) == got


@pytest.mark.parametrize("tool", ["export_rollout", "sweep_members", "probe_width",
                                  "probe_tau_stability", "probe_spectrum", "sweep_temperature"])
def test_rollout_tools_default_to_the_gpu(tool, tmp_path):
    """Without ``--device`` each entry point asks for the GPU, and raises
    where there is none, before it reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    import importlib

    main = importlib.import_module(f"tpuflow_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([CASE, *TINY, "eval.allow_untrained=true", f"train.checkpoint_dir={tmp_path}/c",
              f"eval.output_dir={tmp_path}/e"])
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------ report, compare


def _masked(md: str) -> str:
    return "\n".join("Generated <time>" + line.split("UTC", 1)[1] if line.startswith(
        "Generated ") else line for line in md.splitlines())


def test_report_equals_jax_on_the_oracle_and_a_full_run(tmp_path):
    with pytest.raises(FileNotFoundError, match="tpuflow_torch.cli.evaluate"):
        report.build_report(tmp_path, CASE)
    assert _masked(report.build_report(ORACLE, CASE)) == _masked(
        j_report.build_report(ORACLE, CASE))
    out = tmp_path / CASE
    out.mkdir()
    (out / "eval_metrics.json").write_text((ORACLE / "eval_metrics.json").read_text())
    (out / "rollout_metrics.json").write_text(json.dumps({
        "rollout_steps_per_sec": 56.5, "steps": 16, "n_samples": 64, "temperature": 0.85,
        "backend": "cuda"}))
    (out / "temperature_sweep.json").write_text("[]")
    (out / "tke.png").write_bytes(b"png")
    md = report.build_report(out, CASE)
    assert _masked(md) == _masked(j_report.build_report(out, CASE))
    assert "56.5 steps/s" in md and "## Temperature study" in md and "![tke.png]" in md

    path = report.main([CASE, f"eval.output_dir={tmp_path}",
                        f"train.checkpoint_dir={tmp_path}/none"])
    assert path == out / "report.md" and _masked(path.read_text()) == _masked(md)


def test_compare_runs_equals_jax(tmp_path, capsys):
    a = json.loads((ORACLE / "eval_metrics.json").read_text())
    b = {k: (v * 1.1 if isinstance(v, float) else v) for k, v in a.items()}
    b["n_samples"] = 64
    assert compare_runs.compare(a, b) == j_compare.compare(a, b)
    assert compare_runs.compare(a, b)["rows"]["test_bpd"]["verdict"] in ("better", "worse")
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(a))
    pb.write_text(json.dumps(b))
    for flags in ([], ["--json"]):
        outs = []
        for mod in (compare_runs, j_compare):
            assert mod.main([str(pa), str(pb), *flags]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1]
    assert "CONTEXT MISMATCH: n_samples" in outs[0] or "n_samples" in outs[0]
    with pytest.raises(SystemExit, match="unknown flag"):
        compare_runs.main([str(pa), str(pb), "--Json"])


# ------------------------------------------------------------ inspect_checkpoint


def _trainer_file(tmp_path, mutate=None):
    """A trainer's checkpoint of the tiny model: model, optimizer,
    scheduler, norm and meta, as ``train/trainer.py`` saves it."""
    cfg = load_case(CASE, parse_cli_overrides(TINY))
    model = TMGlow(cfg.model, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.zeros(1, 16, 32, 3), torch.zeros(1, 4, 8, 3),
          tuple((torch.zeros(1, h, w, 8),) * 2 for h, w in ((8, 16), (4, 8))))[0].sum().backward()
    opt.step()
    sched = torch.optim.lr_scheduler.ExponentialLR(opt, 0.99)
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
             "scheduler": sched.state_dict(),
             "norm": {k: torch.ones(3) for k in ("lf_mean", "lf_std", "hf_mean", "hf_std")},
             "meta": {"epoch": 7, "global_step": 70, "config": dataclasses.asdict(cfg)}}
    if mutate:
        mutate(state)
    d = tmp_path / "run"
    Checkpointer(d).save(7, state)
    return d


def test_inspect_checkpoint_sound_and_exporter_files(tmp_path, capsys):
    d = _trainer_file(tmp_path)
    rec = inspect_checkpoint.inspect_checkpoint(d)
    assert rec["ok"], rec["errors"]
    assert rec["steps"] == [7] and rec["epoch"] == 7 and rec["case"] == CASE
    assert rec["model"]["values"] == sum(
        v.numel() for v in torch.load(d / "ckpt_00000007.pt")["model"].values())
    assert rec["optimizer"]["values"] > rec["model"]["values"]  # Adam's two moments
    assert inspect_checkpoint.main([str(d)]) == 0
    assert "checkpoint: OK" in capsys.readouterr().out

    _, pdir = shared_checkpoints(tmp_path / "shared", TINY)
    rec = inspect_checkpoint.inspect_checkpoint(pathlib.Path(pdir) / CASE)
    assert rec["ok"], rec["errors"]
    assert "cannot resume training" in rec["note"] and "optimizer" not in rec


def test_inspect_checkpoint_flags_drift_nonfinite_truncation_and_missing(tmp_path, capsys):
    def mutate(state):
        m = state["model"]
        key = next(k for k in m if k.endswith("conv_in_0.weight"))
        m[key] = torch.cat([m[key]] * 2)
        m["glow.base_prior.prior.prior_conv.bias"] = torch.full_like(
            m["glow.base_prior.prior.prior_conv.bias"], float("nan"))

    d = _trainer_file(tmp_path, mutate)
    rec = inspect_checkpoint.inspect_checkpoint(d)
    msgs = " ".join(rec["errors"])
    assert not rec["ok"] and "non-finite" in msgs and "shape" in msgs
    assert inspect_checkpoint.main([str(d)]) == 1
    assert "UNSOUND" in capsys.readouterr().out

    f = d / "ckpt_00000007.pt"
    f.write_bytes(f.read_bytes()[: f.stat().st_size // 2])
    rec = inspect_checkpoint.inspect_checkpoint(d)
    assert not rec["ok"] and rec["errors"][0].startswith("restore failed")

    missing = tmp_path / "none"
    rec = inspect_checkpoint.inspect_checkpoint(missing)
    assert not rec["ok"] and "does not exist" in rec["errors"][0]
    assert not missing.exists()
    (tmp_path / "empty").mkdir()
    rec = inspect_checkpoint.inspect_checkpoint(tmp_path / "empty")
    assert rec["errors"] == ["no checkpoint found"]


# ------------------------------------------------------------ doctor


def test_doctor_subprocess_runner():
    ok, out = doctor._sub("print('a'); print('b')", timeout=60)
    assert ok and out == "b"
    ok, out = doctor._sub("import tpuflow_torch.kernels.ops; print('op')", timeout=120)
    assert ok and out == "op"  # the child finds the package
    ok, out = doctor._sub("raise ValueError('boom')", timeout=60)
    assert not ok and "boom" in out
    ok, out = doctor._sub("import time; time.sleep(60)", timeout=1)
    assert not ok and "timed out" in out


def test_doctor_warn_only_failures_keep_it_healthy(monkeypatch, capsys):
    def no_gpu(code, timeout, env_extra=None):
        if "cuda" in code:
            return False, "torch.cuda.is_available() is False"
        return True, "ok"

    monkeypatch.setattr(doctor, "_sub", no_gpu)
    assert doctor.main(["--probe-timeout=5"]) == 0
    out = capsys.readouterr().out
    assert "WARN device" in out and "WARN kernel" in out and "doctor: healthy" in out

    monkeypatch.setattr(doctor, "_sub", lambda code, timeout, env_extra=None: (False, "broken"))
    assert doctor.main(["--json"]) == 1
    result = json.loads(capsys.readouterr().out)
    assert not result["ok"] and not result["checks"]["mesh"]["ok"]
    assert result["checks"]["mesh"]["required"] and not result["checks"]["device"]["required"]


def test_doctor_runs_its_checks_here():
    """The real checks on this machine: the required ones (imports, a CPU
    NLL step, a gloo all-reduce between two processes) pass; the GPU's
    pass exactly where torch sees one."""
    result = doctor.run_checks(probe_timeout=120)
    checks = result["checks"]
    assert result["ok"], checks
    assert set(checks) == {"imports", "device", "kernel", "cpu", "mesh", "native", "optional"}
    assert checks["device"]["ok"] == torch.cuda.is_available()
    assert "gloo all-reduce" in checks["mesh"]["detail"]
