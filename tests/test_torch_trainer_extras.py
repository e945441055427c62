"""The training options the port's trainer took over from the JAX trainer,
on the CPU at the tiny model of ``test_torch_train.py``: ``remat``
(against no remat, for the NLL window and the fine-tune loss, as
``tests/test_train.py::test_remat_matches_no_remat``), ``debug_nans``,
``trace_dir``, ``plot_every``, the validation heartbeat, TensorBoard
scalars and ``touch`` (as ``tests/test_logging.py``), and the training
supervisor with fake child processes (as ``tests/test_tools.py``).
"""

import csv
import os
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

import tpuflow_torch.train.trainer as trainer_mod
from tpuflow_torch.cli.train import main as train_main
from tpuflow_torch.configs import ModelConfig, load_case
from tpuflow_torch.data import generate_case
from tpuflow_torch.models import TMGlow, init_lstm_state, perturb_
from tpuflow_torch.tools import supervise_train as sup
from tpuflow_torch.train import Trainer, make_optimizer, train_step, window_bpd_fn
from tpuflow_torch.train import finetune as tft
from tpuflow_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)

TINY = dict(
    n_scales=2, n_flow_steps=2, channels=3, hf_shape=(16, 32), lf_shape=(4, 8),
    coupling_width=8, coupling_layers=2, growth_rate=4, encoder_width=8,
    lstm_hidden=8, cond_channels=8, compute_dtype="float32",
)
B = 2


def _model(seed=0):
    m = TMGlow(ModelConfig(**TINY), device="cpu", seed=seed)
    perturb_(m, 1, 0.05)
    return m


def _data(steps=3, seed=5):
    lf, hf = generate_case("backward-step", B, steps, (16, 32), (4, 8), seed, 3)
    return torch.tensor(lf), torch.tensor(hf)


def _case_cfg(tmp_path, **over):
    base = {f"model.{k}": (",".join(map(str, v)) if isinstance(v, tuple) else v)
            for k, v in TINY.items()}
    base.update({"data.n_train_traj": 2, "data.n_test_traj": 2, "data.train_steps": 3,
                 "data.batch_size": 2, "data.window": 3, "train.epochs": 1,
                 "train.log_every": 0, "train.checkpoint_dir": str(tmp_path)})
    base.update(over)
    return load_case("backward-step", base)


# -------------------------------------------------------------------- remat


def test_remat_window_matches_no_remat():
    """One train step with remat on and off: the same bpd, gradient norm
    and parameters after the Adam step (1e-6)."""
    lf, hf = _data()
    outs = []
    for remat in (True, False):
        m = _model()
        opt, sched = make_optimizer(m.parameters(), 1e-3, 0.99)
        _, met = train_step(m, opt, sched, 1.0, lf, hf, init_lstm_state(m.cfg, B, "cpu"),
                            remat=remat)
        outs.append((met, [p.detach().clone() for p in m.parameters()]))
    (m1, p1), (m2, p2) = outs
    for k in ("bpd", "grad_norm"):
        np.testing.assert_allclose(m1[k].item(), m2[k].item(), atol=1e-6, rtol=1e-6)
    for a, b in zip(p1, p2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # The loss closure itself, with gradients.
    grads = []
    for remat in (True, False):
        m = _model()
        loss, _ = window_bpd_fn(m, remat)(lf, hf, init_lstm_state(m.cfg, B, "cpu"))
        loss.backward()
        grads.append((loss.item(), [p.grad.clone() for p in m.parameters()]))
    assert grads[0][0] == pytest.approx(grads[1][0], rel=1e-6)
    for a, b in zip(grads[0][1], grads[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("draws", ["generator", "eps"])
def test_remat_finetune_loss_matches_no_remat(draws):
    """The fine-tune loss with remat on and off, draws from one seeded
    generator or handed in: the same loss, aux and every gradient
    (log_tau's included), 1e-6. The draws are made outside the
    checkpointed timestep, so the recompute samples the same members."""
    lf, hf = _data(2)
    spec = torch.stack([tft.converged_log_spectra(hf[i]) for i in range(B)])
    outs = []
    for remat in (True, False):
        m = _model()
        lt = torch.log(torch.tensor([0.8, 0.7])).requires_grad_()
        d = (torch.Generator().manual_seed(3) if draws == "generator"
             else tft.window_draws(m, B, 3, 2, torch.Generator().manual_seed(3)))
        loss, aux = tft.make_finetune_loss(m, 3, remat=remat)(
            lt, lf, hf, spec, init_lstm_state(m.cfg, B, "cpu"), 0.5, 0.05, 0.3, d)
        loss.backward()
        outs.append((loss.item(), {k: v.item() for k, v in aux.items() if k != "state"},
                     [p.grad.clone() for p in m.parameters()] + [lt.grad.clone()]))
    (l1, a1, g1), (l2, a2, g2) = outs
    assert np.isfinite(l1) and l1 == pytest.approx(l2, rel=1e-6)
    for k in a1:
        assert a1[k] == pytest.approx(a2[k], rel=1e-6, abs=1e-12), k
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_trainer_passes_remat(tmp_path, monkeypatch):
    seen = []
    step = trainer_mod.trajectory_train_step

    def spy(*args):
        seen.append(args[-1])
        return step(*args)

    monkeypatch.setattr(trainer_mod, "trajectory_train_step", spy)
    Trainer(_case_cfg(tmp_path, **{"train.remat": True}), device="cpu").run()
    assert seen == [True]
    cfg = load_case("backward-step")
    assert cfg.train.remat is False and load_case("cylinder-array").train.remat is False


# --------------------------------------------------------------- debug_nans


def test_debug_nans_names_the_module(tmp_path, monkeypatch):
    """With debug_nans a healthy epoch runs under autograd's anomaly mode
    with no error; a NaN in a parameter raises FloatingPointError naming
    the first module whose output is not finite."""
    anomaly = []
    step = trainer_mod.trajectory_train_step

    def spy(*args):
        anomaly.append(torch.is_anomaly_enabled())
        return step(*args)

    monkeypatch.setattr(trainer_mod, "trajectory_train_step", spy)
    t = Trainer(_case_cfg(tmp_path, **{"train.debug_nans": True, "train.epochs": 2}),
                device="cpu")
    assert np.isfinite(t.run(epochs=1)["mean_bpd"]) and anomaly == [True]
    with torch.no_grad():
        t.model.lstm0.gates_x.weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"'lstm0\.gates_x'"):
        t.run()
    quiet = Trainer(_case_cfg(tmp_path / "off"), device="cpu")
    assert not quiet._nan_hooks and not torch.is_anomaly_enabled()


# ----------------------------------------------------- trace, plot, heartbeat


def test_trace_dir_writes_a_trace(tmp_path):
    Trainer(_case_cfg(tmp_path, **{"train.trace_dir": str(tmp_path / "trace")}),
            device="cpu").run()
    traces = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_plot_every_writes_its_figure(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    t = Trainer(_case_cfg(tmp_path, **{"train.plot_every": 1, "train.epochs": 2}), device="cpu")
    t.run()
    plots = tmp_path / "backward-step" / "train_plots"
    assert sorted(p.name for p in plots.iterdir()) == ["pred_t0001_u.png", "pred_t0002_u.png"]
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    with pytest.raises(ValueError, match="matplotlib"):
        Trainer(_case_cfg(tmp_path / "b", **{"train.plot_every": 1}), device="cpu")


def test_sample_step_draws_from_the_conditioning():
    """sample_step: one draw from (lf_t, state) through the same
    conditioning as nll_and_sample_step's members (same eps)."""
    m = _model()
    lf, hf = _data(1)
    gen = torch.Generator().manual_seed(4)
    eps = tft.window_draws(m, B, 1, 1, gen)[0]
    state = init_lstm_state(m.cfg, B, "cpu")
    with torch.no_grad():
        x, s1 = m.sample_step(lf[:, 0], state, 0.7, eps=eps)
        _, mem, s2 = m.nll_and_sample_step(hf[:, 0], lf[:, 0], state, 0.7, 1, eps=eps)
        x_gen, _ = m.sample_step(lf[:, 0], state, 0.7, generator=torch.Generator().manual_seed(1))
    assert x.shape == (B, 16, 32, 3) and torch.isfinite(x_gen).all()
    torch.testing.assert_close(x, mem[:, 0], rtol=0, atol=0)
    for (h1, c1), (h2, c2) in zip(s1, s2):
        assert torch.equal(h1, h2) and torch.equal(c1, c2)


def test_validation_touches_the_heartbeat(tmp_path):
    log = tmp_path / "train_log.csv"
    logger = MetricsLogger(log, quiet=True)
    logger.log(0, bpd=1.0)
    old = log.stat()
    os.utime(log, (old.st_atime, old.st_mtime - 100))
    before = log.stat().st_mtime
    t = Trainer(_case_cfg(tmp_path, **{"train.eval_every": 1}), device="cpu", logger=logger)
    assert np.isfinite(t.run()["val_bpd"])
    t.close()
    logger.close()
    assert log.stat().st_mtime > before


# ------------------------------------------------------------------ logging


def _tb_scalars(tb_dir, tag):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tb_dir))
    acc.Reload()
    return {e.step: e.value for e in acc.Scalars(tag)}


def test_tensorboard_summaries(tmp_path):
    """As the JAX logger's test: two rows, the float scalars under their
    names at their steps."""
    pytest.importorskip("tensorboard")
    tb = tmp_path / "tb"
    lg = MetricsLogger(quiet=True, tensorboard_dir=tb)
    lg.log(1, bpd=2.5)
    lg.log(2, bpd=2.0)
    lg.close()
    assert list(tb.glob("events.out.tfevents.*"))
    assert _tb_scalars(tb, "bpd") == {1: 2.5, 2: 2.0}


def test_tensorboard_missing_warns_and_keeps_csv(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    lg = MetricsLogger(tmp_path / "log.csv", quiet=True, tensorboard_dir=tmp_path / "tb")
    lg.log(1, bpd=2.5)
    lg.close()
    assert "TensorBoard logging disabled" in capsys.readouterr().err
    assert not (tmp_path / "tb").exists()
    assert float(next(csv.DictReader(open(tmp_path / "log.csv")))["bpd"]) == 2.5


def test_cli_train_writes_tensorboard(tmp_path):
    pytest.importorskip("tensorboard")
    over = [f"model.{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
            for k, v in TINY.items()]
    train_main(["backward-step", *over, "data.n_train_traj=2", "data.train_steps=3",
                "data.batch_size=2", "data.window=3", "train.epochs=1", "train.log_every=1",
                f"train.checkpoint_dir={tmp_path}", f"train.tensorboard_dir={tmp_path}/tb",
                "--device", "cpu"])
    vals = _tb_scalars(tmp_path / "tb", "bpd")
    rows = list(csv.DictReader(open(tmp_path / "backward-step" / "train_log.csv")))
    assert vals == {1: pytest.approx(float(rows[0]["bpd"]), rel=1e-6)}


def test_logger_touch_advances_mtime(tmp_path):
    """As the JAX logger's test: touch() bumps the CSV mtime without
    adding rows; a no-op with no path or before the first row."""
    MetricsLogger(quiet=True).touch()
    p = tmp_path / "train_log.csv"
    lg = MetricsLogger(p, quiet=True)
    lg.touch()
    assert not p.exists()
    lg.log(1, bpd=2.0)
    old = os.stat(p)
    os.utime(p, (old.st_atime, old.st_mtime - 100))
    before = os.stat(p).st_mtime
    lg.touch()
    assert os.stat(p).st_mtime > before
    assert len(p.read_text().splitlines()) == 2
    lg.close()


# --------------------------------------------------------------- supervisor


def _sup_cfg(**kw):
    base = dict(stall_timeout=1.0, compile_grace=1.5, max_restarts=3, poll_interval=0.1,
                max_leg_seconds=0.0, wedge_cooldown=0.0)
    base.update(kw)
    return sup.SupervisorConfig(**base)


def _child(code):
    # -S skips site initialization: these children are stdlib-only.
    return [sys.executable, "-S", "-c", code]


def test_supervisor_restarts_a_stalled_child(tmp_path):
    """A child that heartbeats once and then hangs is killed at the stall
    timeout and relaunched; the relaunch completes."""
    hb, marker = tmp_path / "train_log.csv", tmp_path / "ran"
    child = (f"import pathlib, sys, time\nhb, m = pathlib.Path({str(hb)!r}), "
             f"pathlib.Path({str(marker)!r})\nif m.exists():\n    sys.exit(0)\n"
             "m.touch()\nhb.touch()\ntime.sleep(60)\n")
    t0 = time.monotonic()
    res = sup.supervise(_child(child), hb, _sup_cfg(), log=lambda m: None)
    assert (res.exit_code, res.restarts, res.stalls, res.crashes) == (0, 1, 1, 0)
    assert time.monotonic() - t0 < 30


def test_supervisor_restarts_a_crashed_child(tmp_path):
    """A crash (nonzero exit) relaunches at once; a child that always
    crashes spends the budget and the supervisor exits 1."""
    hb, marker = tmp_path / "train_log.csv", tmp_path / "ran"
    child = (f"import pathlib, sys\nm = pathlib.Path({str(marker)!r})\n"
             "if m.exists():\n    sys.exit(0)\nm.touch()\nsys.exit(3)\n")
    res = sup.supervise(_child(child), hb, _sup_cfg(wedge_cooldown=60.0), log=lambda m: None)
    assert (res.exit_code, res.restarts, res.stalls, res.crashes) == (0, 1, 0, 1)
    res = sup.supervise(_child("import sys; sys.exit(2)"), hb, _sup_cfg(max_restarts=2),
                        log=lambda m: None)
    assert (res.exit_code, res.restarts, res.crashes) == (1, 2, 3)


def test_supervisor_main_runs_the_port_trainer(tmp_path, monkeypatch):
    """main() splits its own flags from the trainer's, passes --device
    through, and watches the case's train_log.csv."""
    seen = {}

    def fake(cmd, heartbeat, cfg):
        seen.update(cmd=cmd, heartbeat=pathlib.Path(heartbeat), cfg=cfg)
        return sup.SupervisorResult(0, 0, 0, 0)

    monkeypatch.setattr(sup, "supervise", fake)
    code = sup.main(["backward-step", f"train.checkpoint_dir={tmp_path}", "--device", "cpu",
                     "--max-restarts=2", "--stall-timeout=5"])
    assert code == 0
    assert seen["cmd"][1:] == ["-m", "tpuflow_torch.cli.train", "backward-step",
                               f"train.checkpoint_dir={tmp_path}", "--device", "cpu"]
    assert seen["heartbeat"] == tmp_path / "backward-step" / "train_log.csv"
    assert (seen["cfg"].max_restarts, seen["cfg"].stall_timeout) == (2, 5.0)
    with pytest.raises(SystemExit, match="unknown supervisor flag"):
        sup.main(["backward-step", "--nope=1"])
