"""The committed cylinder-array weights in the port, against JAX.

``runs/r5_cyl_ft`` (Orbax, step 10: the fine-tuned cylinder-array model,
fixture v2, ``z_clip`` 4) through ``tools/export_to_torch.py`` into a
temporary directory, loaded by the port's ``load_eval_bundle``: its meta,
deployed temperature and normalization equal JAX's, and 2 members x 2
steps of the rollout at float32, with JAX's draws handed to the port as
``eps``, agree within 1e-4 x max(1, max |ref|), as the flagship's
(``test_torch_loading.py``). The bf16 bits/dim comparison of
``tools/bf16_gap.py`` is not repeated here (minutes on this CPU).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_loading import _exporter, _jax_eps

from tpuflow.configs.config import load_case as j_load_case
from tpuflow.eval.loading import load_eval_bundle as j_load_eval_bundle
from tpuflow.eval.loading import resolve_temperature as j_resolve_temperature
from tpuflow.eval.rollout import make_ensemble_rollout as j_make_ensemble_rollout
from tpuflow_torch.configs import load_case
from tpuflow_torch.data import load_dataset
from tpuflow_torch.eval import load_eval_bundle, make_ensemble_rollout, resolve_temperature

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CYLINDER = ROOT / "runs" / "r5_cyl_ft" / "checkpoints"
CASE = "cylinder-array"
TOL = 1e-4


def test_cylinder_export_loads_and_matches_jax(tmp_path):
    out = _exporter().export(CASE, CYLINDER, tmp_path, step=10)
    assert out == tmp_path / CASE / "ckpt_00000010.pt"

    # The fixture it was trained on; one short test trajectory for the LF.
    over = {"train.checkpoint_dir": str(tmp_path), "model.compute_dtype": "float32",
            "data.fixture_version": 2, "data.n_test_traj": 1, "data.train_steps": 2}
    cfg = load_case(CASE, over)
    model, norm, meta = load_eval_bundle(cfg, device="cpu")
    jcfg = j_load_case(CASE, {**over, "train.checkpoint_dir": str(CYLINDER)})
    jm, v, jnorm, jmeta = j_load_eval_bundle(jcfg)
    assert meta["epoch"] == jmeta["epoch"] and meta["config"] == jmeta["config"]
    assert meta["config"]["model"]["z_clip"] == cfg.model.z_clip == 4.0
    assert meta["config"]["data"]["fixture_version"] == 2
    tau = resolve_temperature(cfg, meta, device="cpu")
    tau_j = j_resolve_temperature(jcfg, jmeta)
    np.testing.assert_array_equal(np.asarray(tau, np.float32), np.asarray(tau_j, np.float32))
    for k, a in jnorm.to_dict().items():
        np.testing.assert_array_equal(norm.to_dict()[k], a)

    lf = load_dataset(cfg.data, cfg.model, "test", norm=norm).lf[0, :2]
    key = jax.random.PRNGKey(0)
    want = np.asarray(j_make_ensemble_rollout(jm, 2, tau_j, "fields")(v, jnp.asarray(lf), key))
    got = make_ensemble_rollout(model, 2, tau, "fields")(
        torch.from_numpy(lf), eps=_jax_eps(key, model.cfg, 2, 2))
    assert want.shape == (2, 2, 96, 96, 3)
    assert np.isfinite(want).all() and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))
