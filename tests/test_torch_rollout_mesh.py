"""The member split of the port's rollout (``make_ensemble_rollout(mesh=)``
and ``make_batched_ensemble_rollout(mesh=)``) on a mesh of two CPU
entries, each chunk on its own replica of the model:

* against JAX's ``make_ensemble_rollout(mesh=make_mesh(1, 2))`` and its
  batched rollout on ``make_mesh(2, 1)``, on JAX's draws handed over as
  ``eps`` (1e-4 x max(1, max|ref|), as the flat parity tests of
  ``tests/test_torch_models.py``);
* against the flat port rollout on one generator, for stats and fields,
  with and without a forced overflow redraw: the same draws reach the
  same members, so only the two chunks' batch sizes differ (1e-5
  relative);
* the rollout CLI choosing flat or split by the devices it sees.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.configs.config import ModelConfig as JModelConfig
from tpuflow.eval.rollout import make_batched_ensemble_rollout as j_make_batched_rollout
from tpuflow.eval.rollout import make_ensemble_rollout as j_make_ensemble_rollout
from tpuflow.models import TMGlow as JTMGlow
from tpuflow.models import init_lstm_state as j_init_lstm_state
from tpuflow.train.mesh import make_mesh as j_make_mesh
from tpuflow_torch.cli import rollout as cli_rollout
from tpuflow_torch.configs import ModelConfig, load_case, parse_cli_overrides
from tpuflow_torch.convert import from_flax
from tpuflow_torch.eval import make_batched_ensemble_rollout, make_ensemble_rollout
from tpuflow_torch.models import TMGlow, latent_shapes
from tpuflow_torch.train import make_mesh

torch.set_num_threads(1)

SMALL = dict(
    n_scales=2, n_flow_steps=2, channels=3, hf_shape=(16, 32), lf_shape=(4, 8),
    coupling_width=16, coupling_layers=2, growth_rate=8, encoder_width=8,
    lstm_hidden=8, cond_channels=8, compute_dtype="float32", z_clip=4.0,
)
N, T, TAU = 4, 4, 0.85
CPU2 = ["cpu", "cpu"]


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    jm = JTMGlow(JModelConfig(conv_layout="nhwc", **SMALL))
    v = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(_np(1, (2, 16, 32, 3))),
        jnp.asarray(_np(2, (2, 4, 8, 3))), j_init_lstm_state(jm.cfg, (2,))))
    rng = np.random.default_rng(3)
    v = {**v, "params": jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v["params"])}
    tm = TMGlow(ModelConfig(**SMALL), device="cpu")
    tm.load_state_dict(from_flax(v, tm))
    return jm, v, tm


def _jax_eps(key, cfg, n, steps):
    """JAX's draws of a rollout: split(key) per step, split(sub, L) per
    scale (tests/test_torch_models.py)."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, cfg.n_scales)
        out.append([torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
                    for k, s in zip(keys, latent_shapes(cfg, n))])
    return out


def _rel_close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("collect", ["stats", "fields"])
def test_split_rollout_matches_jax_mesh(pair, collect):
    jm, v, tm = pair
    lf = _np(19, (T, 4, 8, 3))
    key = jax.random.PRNGKey(20)
    want = j_make_ensemble_rollout(jm, N, TAU, collect, mesh=j_make_mesh(1, 2))(
        v, jnp.asarray(lf), key)
    split = make_ensemble_rollout(tm, N, TAU, collect, mesh=make_mesh(1, 2, devices=CPU2))
    got = split(torch.tensor(lf), eps=_jax_eps(key, tm.cfg, N, T))
    if collect == "fields":
        assert got.shape == (T, N, 16, 32, 3)
        _rel_close(got.numpy(), want, 1e-4)
        return
    for k in ("mean", "var"):
        assert got[k].shape == (T, 16, 32, 3)
        _rel_close(got[k].numpy(), want[k], 1e-4)


def _force_overflow(monkeypatch):
    """Every member whose first base-prior draw exceeds 0.5 overflows at
    its first sample of a step (tau > 0.7; the redraw samples at 0.6 x
    0.85): a rule on the member's own draw, so it marks the same members
    in a chunk as in the flat batch."""
    orig = TMGlow.sample_from_feats

    def forced(self, feats, state, *, temperature=1.0, eps=None, **kw):
        x, s = orig(self, feats, state, temperature=temperature, eps=eps, **kw)
        if float(torch.as_tensor(temperature).max()) > 0.7:
            bad = eps[-1].flatten(1)[:, 0] > 0.5
            x = torch.where(bad.view(-1, 1, 1, 1), torch.full_like(x, float("inf")), x)
        return x, s

    monkeypatch.setattr(TMGlow, "sample_from_feats", forced)


@pytest.mark.parametrize("redraw", [False, True], ids=["plain", "redraw"])
@pytest.mark.parametrize("collect", ["stats", "fields"])
def test_split_equals_flat_on_one_generator(pair, monkeypatch, collect, redraw):
    _, _, tm = pair
    lf = torch.tensor(_np(21, (T, 4, 8, 3)))
    n = 8
    if redraw:
        _force_overflow(monkeypatch)
    flat = make_ensemble_rollout(tm, n, TAU, collect, overflow_redraw=redraw)
    split = make_ensemble_rollout(tm, n, TAU, collect, overflow_redraw=redraw,
                                  mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    want = flat(lf, torch.Generator().manual_seed(5))
    got = split(lf, torch.Generator().manual_seed(5))
    pairs = [(got, want)] if collect == "fields" else [(got[k], want[k]) for k in want]
    for g, w in pairs:
        assert torch.isfinite(g).all()  # with the redraw: the forced members were replaced
        _rel_close(g.numpy(), w.numpy(), 1e-5)


def test_batched_rollout_on_a_data_mesh(pair):
    """Trajectories over the data axis: against JAX's batched rollout on
    make_mesh(2, 1) (shared draws) and the flat port batch (generators)."""
    jm, v, tm = pair
    b, n, steps = 4, 3, 3
    lfs = _np(24, (b, steps, 4, 8, 3))
    rngs = jax.random.split(jax.random.PRNGKey(25), b)
    want = j_make_batched_rollout(jm, n, TAU, mesh=j_make_mesh(2, 1))(v, jnp.asarray(lfs), rngs)
    split = make_batched_ensemble_rollout(tm, n, TAU, mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    got = split(torch.tensor(lfs), eps=[_jax_eps(rngs[i], tm.cfg, n, steps) for i in range(b)])
    for k in ("mean", "var"):
        assert got[k].shape == (b, steps, 16, 32, 3)
        _rel_close(got[k].numpy(), want[k], 1e-4)
    gens = lambda: [torch.Generator().manual_seed(i) for i in range(b)]  # noqa: E731
    flat = make_batched_ensemble_rollout(tm, n, TAU, "fields")(torch.tensor(lfs), gens())
    fields = make_batched_ensemble_rollout(tm, n, TAU, "fields", mesh=make_mesh(
        2, 1, devices=CPU2))(torch.tensor(lfs), gens())
    _rel_close(fields.numpy(), flat.numpy(), 1e-5)
    with pytest.raises(ValueError, match="do not split"):
        split(torch.tensor(lfs[:3]), gens()[:3])


def test_split_errors_and_replicas(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="does not split"):
        make_ensemble_rollout(tm, 6, TAU, mesh=make_mesh(1, 4, devices=["cpu"] * 4))
    from tpuflow_torch.eval.rollout import _replicas

    first, second = _replicas(tm, CPU2)
    assert first is tm and second is not tm
    for (name, a), b in zip(tm.state_dict().items(), second.state_dict().values()):
        assert torch.equal(a, b), name


def _cli_args(tmp_path):
    return [
        "backward-step", "model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
        "model.coupling_layers=2", "model.growth_rate=4", "model.encoder_width=8",
        "model.lstm_hidden=8", "model.cond_channels=8", "model.hf_shape=16,32",
        "model.lf_shape=4,8", "model.compute_dtype=float32", "data.n_train_traj=2",
        "data.n_test_traj=1", "data.train_steps=4", "eval.rollout_steps=3", "eval.n_samples=4",
        "eval.allow_untrained=true", f"train.checkpoint_dir={tmp_path}/ckpt",
        f"eval.output_dir={tmp_path}/eval",
    ]


def test_cli_chooses_flat_or_split(tmp_path, monkeypatch):
    cpu = torch.device("cpu")
    assert cli_rollout.visible_devices(cpu) == [cpu]
    assert cli_rollout.member_mesh([cpu], 4) is None
    assert cli_rollout.member_mesh([cpu] * 3, 4) is None
    assert cli_rollout.member_mesh([cpu] * 2, 4).size == 2
    cfg = load_case("backward-step", parse_cli_overrides(_cli_args(tmp_path)[1:]))
    out = tmp_path / "eval" / "backward-step"
    flat_metrics, _ = cli_rollout.rollout(cfg, "cpu")
    flat = np.load(out / "rollout_stats.npz")
    flat = {k: flat[k] for k in flat.files}
    monkeypatch.setattr(cli_rollout, "visible_devices", lambda dev: [dev, dev])
    split_metrics, _ = cli_rollout.rollout(cfg, "cpu")
    split = np.load(out / "rollout_stats.npz")
    assert (flat_metrics["devices"], split_metrics["devices"]) == (1, 2)
    assert json.loads((out / "rollout_metrics.json").read_text())["devices"] == 2
    for k in ("mean", "var"):
        _rel_close(split[k], flat[k], 1e-5)
