"""The deployment chain of the port on the committed flagship, on the CPU.

``weights/r5_v3_deep_ft`` (the backward-step flagship, fixture v3, learned
tau) goes through the chain the JAX package ran on it: the evaluator
(``cli/evaluate.py``'s compute half) at the evaluator oracle's cut sizes
(``tools/make_eval_oracle.py``: 4 members, 8 rollout steps, 6 calibration
steps, 16 reference steps, batches of 2 trajectories) on 2 test
trajectories (one to fit the calibration, one to score it), then the exporter
(``tools/export_rollout.py``) from the evaluation's output directory, then
the server (``tools/serve.py``) on the artifact. Held:

  * the evaluation's ``test_bpd`` equals the evaluator's form of
    ``weights_reference`` at its 8 steps, bit for bit (the CPU's NLL is
    deterministic), and its fitted ``spread_scale`` and coverages are in
    range;
  * the sidecar holds every key of the JAX package's sidecar of the same
    flagship (``runs/r5_v3_deep_ft/eval/backward-step/rollout.meta.json``)
    plus ``torch_version``; ``case``, ``n_scales``, ``default_temperature``
    (the learned tau), ``lf_mean`` and ``lf_std`` equal JAX's values;
    ``spread_scale`` and ``interval_scales`` equal the port's own
    ``eval_metrics.json``;
  * the served stats equal ``make_ensemble_rollout`` on a generator seeded
    the same way, denormalized, bit for bit;
  * the calibrated variance equals the variance times ``spread_scale``
    squared, the mean unchanged, in batch and over one HTTP request;
  * ``RolloutServer.rollout(calibrated=True)`` refuses a sidecar without
    ``spread_scale``.
"""

import io
import json
import pathlib
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tpuflow_torch.cli.evaluate import evaluate
from tpuflow_torch.configs import load_case, parse_cli_overrides
from tpuflow_torch.data import load_dataset
from tpuflow_torch.eval import load_eval_bundle, make_ensemble_rollout, resolve_temperature
from tpuflow_torch.tools import export_rollout
from tpuflow_torch.tools import weights_reference as wr
from tpuflow_torch.tools.serve import RolloutServer, make_http_server

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "weights" / "r5_v3_deep_ft"
CASE = "backward-step"
JAX_SIDECAR = ROOT / "runs" / "r5_v3_deep_ft" / "eval" / CASE / "rollout.meta.json"
# The evaluator oracle's cut (tools/make_eval_oracle.py) on the flagship's
# own fixture, 2 test trajectories.
CUT = ["data.fixture_version=3", "data.n_test_traj=2", "eval.n_samples=4",
       "eval.rollout_steps=8", "eval.calibration_steps=6", "eval.ref_steps=16",
       "eval.traj_batch=2"]
SEED = 5


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The flagship evaluated, exported from the evaluation's directory and
    loaded by the server, and one served rollout; the model and test split
    for the eager side."""
    out = tmp_path_factory.mktemp("deploy")
    args = [*CUT, f"train.checkpoint_dir={FLAGSHIP}", f"eval.output_dir={out}"]
    cfg = load_case(CASE, parse_cli_overrides(args))
    metrics, _ = evaluate(cfg, "cpu")
    path = export_rollout.main([CASE, *args, "--device", "cpu"])
    model, norm, meta = load_eval_bundle(cfg, device="cpu")
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    server = RolloutServer(path, device="cpu")
    lf = ds.lf[0, :cfg.eval.rollout_steps].copy()
    return dict(out=out, cfg=cfg, metrics=metrics, path=path, model=model, meta=meta, ds=ds,
                server=server, lf=lf, plain=server.rollout(lf, seed=SEED, normalized=True))


def test_evaluation_of_the_flagship(chain):
    m, cfg = chain["metrics"], chain["cfg"]
    assert m["steps"] == cfg.eval.rollout_steps and m["backend"] == "cpu"
    steps, value = wr.evaluator_bpd(FLAGSHIP, "cpu", cfg.eval.rollout_steps,
                                    **{"data.n_test_traj": cfg.data.n_test_traj})
    assert (steps, m["test_bpd"]) == (cfg.eval.rollout_steps, value)
    assert np.isfinite([m["spread_scale"], *m["interval_scales"].values()]).all()
    assert m["spread_scale"] > 0 and all(v > 0 for v in m["interval_scales"].values())
    assert all(0.0 <= v <= 1.0 for v in m["coverage"].values())
    saved = json.loads((chain["out"] / CASE / "eval_metrics.json").read_text())
    assert saved == m


def test_sidecar_carries_the_flagship_and_its_calibration(chain):
    want = json.loads(JAX_SIDECAR.read_text())
    got = json.loads(chain["path"].with_suffix(".meta.json").read_text())
    assert set(got) == set(want) | {"torch_version"}
    for k in ("case", "n_scales", "default_temperature", "lf_mean", "lf_std"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["default_temperature"], chain["meta"]["learned_tau"],
                               rtol=0, atol=1e-7)
    m = chain["metrics"]
    assert got["spread_scale"] == m["spread_scale"]
    assert got["interval_scales"] == m["interval_scales"]
    assert (got["rollout_steps"], got["n_samples"]) == (8, 4)
    assert got["platforms"] == ["cpu"] and got["torch_version"] == torch.__version__


def test_served_stats_equal_the_eager_rollout(chain):
    served = chain["plain"]
    cfg, ds = chain["cfg"], chain["ds"]
    tau = resolve_temperature(cfg, chain["meta"], device="cpu")
    with torch.no_grad():
        ref = make_ensemble_rollout(chain["model"], cfg.eval.n_samples, tau, "stats")(
            torch.from_numpy(chain["lf"]), torch.Generator().manual_seed(SEED))
    want = {"mean": ds.denorm_hf(ref["mean"]).numpy(), "var": ds.denorm_hf_var(ref["var"]).numpy()}
    for k in ("mean", "var"):
        assert served[k].shape == (8, *cfg.model.hf_shape, cfg.model.channels)
        assert np.isfinite(served[k]).all()
        np.testing.assert_array_equal(served[k], want[k], err_msg=k)


def test_calibrated_variance_in_batch_and_over_http(chain):
    server, lf, plain = chain["server"], chain["lf"], chain["plain"]
    s2 = np.float32(chain["metrics"]["spread_scale"]) ** 2
    cal = server.rollout(lf, seed=SEED, normalized=True, calibrated=True)
    np.testing.assert_array_equal(cal["mean"], plain["mean"])
    np.testing.assert_array_equal(cal["var"], plain["var"] * s2)
    assert not np.array_equal(cal["var"], plain["var"])

    httpd = make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.savez(buf, lf=lf)
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/rollout?seed={SEED}&normalized=1"
            "&calibrated=1", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            assert len(body) == int(resp.headers["Content-Length"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    with np.load(io.BytesIO(body)) as got:
        for k in ("mean", "var"):
            np.testing.assert_array_equal(got[k], cal[k], err_msg=k)


def test_calibrated_rollout_needs_the_fitted_spread(chain, tmp_path):
    meta = json.loads(chain["path"].with_suffix(".meta.json").read_text())
    del meta["spread_scale"]
    bare = tmp_path / "rollout.meta.json"
    bare.write_text(json.dumps(meta))
    server = RolloutServer(chain["path"], meta_path=bare, device="cpu")
    with pytest.raises(ValueError, match="no spread_scale"):
        server.rollout(chain["lf"], seed=SEED, normalized=True, calibrated=True)
