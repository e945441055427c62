"""The trained weights committed in the port's format, against their JAX
sources.

  * ``weights/r5_v3_deep_ft`` (the backward-step flagship,
    ``runs/r5_v3_deep_ft`` step 16), ``weights/r5_cyl_ft`` (the
    cylinder-array one, ``runs/r5_cyl_ft`` step 10) and
    ``runs/r5_eval_oracle_torch/weights`` (the evaluator oracle's,
    ``runs/r4_bstep_deeper`` step 800) each equal a fresh export of their
    Orbax step through ``tools/export_to_torch.py``: every tensor, the
    norm and the meta (``learned_tau``, config), all but ``source``, which
    names the Orbax directory relative to the repo.
  * ``reference.json`` beside each committed flagship (what the card
    checks) holds what ``tpuflow_torch.tools.weights_reference`` computes
    from it on the CPU, bit for bit (deterministic on the CPU, one thread
    or eight, measured): the f32 rollout's summary, the 8-step bf16
    bits/dim and the evaluator's ``test_bpd`` at its own step count, both
    in the checkpoint's default numerics. The flagship's 8-step bits/dim is
    also held to JAX's default path in ``tests/test_torch_bf16.py``.
  * The flagship's bf16 rollout stats (2 members x 2 steps, JAX's draws as
    ``eps``) against JAX's in each numerics: the default path's
    (``use_pallas: false``, the flagship's own) and the fused coupling's
    (``use_pallas`` through ``xla_reference``), JAX in a subprocess with
    ``--xla_allow_excess_precision=false`` as in ``tests/test_torch_bf16.py``.
    A reverse pass of 24 couplings at bf16 amplifies one-ulp roundings of
    conv inputs: JAX's own two evaluations of the program (excess precision
    off and on, in a second subprocess) differ by up to 1.5e-2 in the mean
    and 1.2e-2 in the variance (measured on the CPU; the mean's max |ref| is 2.8),
    and the port lies as far from JAX's as they lie from each other. So the
    port's largest difference from JAX's, per statistic, must not exceed
    JAX's own plus 5e-3 x max(1, max |ref|), the port's bf16 tolerance for
    rollout stats (``chip_smoke.py`` SPLIT_TOL / SERVE_TOL); and the mean
    difference, 5e-3 x max(1, max |ref|) alone (JAX's own: 1.5e-3 and
    3.8e-4). A fault of the port (a wrong tau, draw or coupling) moves the
    stats by O(1).
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow_torch.eval import make_ensemble_rollout, resolve_temperature
from tpuflow_torch.models import latent_shapes
from tpuflow_torch.tools import weights_reference as wr

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "weights" / "r5_v3_deep_ft"
CYLINDER = ROOT / "weights" / "r5_cyl_ft"
COMMITTED = {
    "flagship": ("runs/r5_v3_deep_ft/checkpoints", 16, FLAGSHIP),
    "cylinder": ("runs/r5_cyl_ft/checkpoints", 10, CYLINDER),
    "oracle": ("runs/r4_bstep_deeper/checkpoints", 800,
               ROOT / "runs" / "r5_eval_oracle_torch" / "weights"),
}
# Each fine-tuned checkpoint's learned per-scale tau (its JAX meta).
LEARNED_TAU = {"flagship": [0.8697, 0.8609, 0.8646], "cylinder": [0.7616, 0.7575, 0.8591]}
BF16_TOL = 5e-3


def _exporter():
    spec = importlib.util.spec_from_file_location("export_to_torch",
                                                  ROOT / "tools" / "export_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_weights_equal_a_fresh_export(tmp_path, name):
    orbax, step, weights = COMMITTED[name]
    case = wr.case_of(weights)
    assert case == ("cylinder-array" if name == "cylinder" else "backward-step")
    fresh_path = _exporter().export(case, ROOT / orbax, tmp_path, step=step)
    committed_path = weights / case / f"ckpt_{step:08d}.pt"
    fresh = torch.load(fresh_path, weights_only=True)
    committed = torch.load(committed_path, weights_only=True)
    assert set(committed) == set(fresh) == {"model", "norm", "meta"}
    for part in ("model", "norm"):
        assert list(committed[part]) == list(fresh[part]), part
        for k, v in fresh[part].items():
            assert committed[part][k].dtype == v.dtype and torch.equal(committed[part][k], v), k
    assert committed["meta"]["source"] == orbax
    assert {k: v for k, v in committed["meta"].items() if k != "source"} == {
        k: v for k, v in fresh["meta"].items() if k != "source"}
    meta = committed["meta"]
    assert meta["config"]["data"]["fixture_version"] == (3 if name == "flagship" else 2)
    assert meta["config"]["model"]["use_pallas"] is False
    if name in LEARNED_TAU:
        np.testing.assert_allclose(meta["learned_tau"], LEARNED_TAU[name], atol=1e-4)
    if name == "cylinder":
        assert meta["config"]["model"]["z_clip"] == 4.0


def _reference_is_the_cpus(weights, case):
    """``weights``' reference.json against a fresh CPU computation."""
    ref = json.loads((weights / "reference.json").read_text())
    assert ref["case"] == wr.case_of(weights) == case
    for key, steps in (("bpd", wr.BPD_STEPS), ("test_bpd", 64)):
        assert (ref[key]["steps"], ref[key]["dtype"], ref[key]["use_pallas"]) == (
            steps, "bfloat16", False), key
    r = ref["rollout"]
    assert (r["dtype"], r["seed"], r["n_samples"], r["steps"], r["grid"]) == (
        "float32", wr.ROLLOUT_SEED, wr.ROLLOUT_MEMBERS, wr.ROLLOUT_STEPS, wr.GRID)
    with torch.no_grad():
        stats = wr.f32_rollout(weights, "cpu")
        assert wr.heldout_bpd(weights, "cpu") == ref["bpd"]["value"]
        assert wr.evaluator_bpd(weights, "cpu") == (64, ref["test_bpd"]["value"])
    assert all(bool(torch.isfinite(v).all()) for v in stats.values())
    assert wr.summarize(stats) == r["stats"]
    # The summary's grid holds the ensemble mean and variance as they are.
    for k, v in stats.items():
        assert np.asarray(r["stats"][k]["grid"]).shape == (
            wr.ROLLOUT_STEPS, v.shape[1] // wr.GRID * (v.shape[2] // wr.GRID) * v.shape[3])
    return ref


def test_reference_json_is_the_cpus():
    _reference_is_the_cpus(FLAGSHIP, "backward-step")


def test_cylinder_reference_json_is_the_cpus():
    ref = _reference_is_the_cpus(CYLINDER, "cylinder-array")
    assert abs(ref["bpd"]["value"] / -8.978182 - 1) < 1e-4


_JAX_ROLLOUT = """
import sys
import jax
import numpy as np
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, "tools")
from bf16_gap import CHECKPOINTS, jax_fused_path
from tpuflow.configs.config import load_case
from tpuflow.data.dataset import load_dataset
from tpuflow.eval.loading import load_eval_bundle, resolve_temperature
from tpuflow.eval.rollout import make_ensemble_rollout
import contextlib
n, steps, out, fused = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4] == "fused"
cfg = load_case("backward-step", {"train.checkpoint_dir": str(CHECKPOINTS["flagship"]),
                                  "model.use_pallas": fused, "data.fixture_version": 3})
model, variables, norm, meta = load_eval_bundle(cfg)
lf = load_dataset(cfg.data, cfg.model, "test", norm=norm).lf[0, :steps]
with jax_fused_path() if fused else contextlib.nullcontext():
    stats = make_ensemble_rollout(model, n, resolve_temperature(cfg, meta), "stats")(
        variables, jax.numpy.asarray(lf), jax.random.PRNGKey(0))
np.savez(out, mean=np.asarray(stats["mean"]), var=np.asarray(stats["var"]),
         excess_precision="--xla_allow_excess_precision=false" not in
         __import__("os").environ.get("XLA_FLAGS", ""))
"""


def _jax_eps(key, cfg, n, steps):
    """JAX's draws of a rollout: split(key) per step, split(sub, L) per
    scale, one normal draw per scale."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, cfg.n_scales)
        out.append([torch.tensor(np.asarray(jax.random.normal(k, s, jnp.float32)))
                    for k, s in zip(keys, latent_shapes(cfg, n))])
    return out


def _flagship_bf16_rollout_vs_jax(tmp_path, numerics: str):
    """The flagship's bf16 rollout stats at ``model.use_pallas`` of
    ``numerics`` against JAX's in the same numerics (module docstring)."""
    n, steps = 2, 2
    procs = {}
    for excess in (False, True):
        flags = "" if excess else "--xla_allow_excess_precision=false"
        env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
        procs[excess] = subprocess.Popen(
            [sys.executable, "-c", _JAX_ROLLOUT, str(n), str(steps),
             str(tmp_path / f"{excess}.npz"), numerics],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    jax_out = {}
    for excess, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        jax_out[excess] = np.load(tmp_path / f"{excess}.npz")
        assert bool(jax_out[excess]["excess_precision"]) == excess

    cfg, model, norm, meta = wr.load(FLAGSHIP, "cpu",
                                     **{"model.use_pallas": numerics == "fused"})
    assert cfg.model.compute_dtype == "bfloat16"
    from tpuflow_torch.data import load_dataset

    lf = torch.from_numpy(load_dataset(cfg.data, cfg.model, "test", norm=norm).lf[0, :steps])
    with torch.no_grad():
        got = make_ensemble_rollout(model, n, resolve_temperature(cfg, meta, device="cpu"))(
            lf, eps=_jax_eps(jax.random.PRNGKey(0), cfg.model, n, steps))
    for k in ("mean", "var"):
        ref = jax_out[False][k]
        tol = BF16_TOL * max(1.0, float(np.abs(ref).max()))
        assert np.isfinite(ref).all() and bool(torch.isfinite(got[k]).all())
        err = np.abs(got[k].numpy() - ref)
        jax_gap = float(np.abs(jax_out[True][k] - ref).max())
        assert err.max() <= jax_gap + tol, (k, float(err.max()), jax_gap, tol)
        assert err.mean() <= tol, (k, float(err.mean()), tol)


def test_flagship_bf16_rollout_matches_jax_fused_path(tmp_path):
    _flagship_bf16_rollout_vs_jax(tmp_path, "fused")


def test_flagship_bf16_rollout_matches_jax_default_path(tmp_path):
    """The flagship's own numerics (its meta's ``use_pallas: false``)."""
    assert wr.checkpoint_meta(FLAGSHIP)["config"]["model"]["use_pallas"] is False
    _flagship_bf16_rollout_vs_jax(tmp_path, "default")
