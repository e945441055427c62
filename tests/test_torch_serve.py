"""The port's serving artifact and server against the JAX package.

  * K2 as a registered operator: ``torch.ops.tpuflow_torch.fused_coupling``
    bit-equal to ``fused_coupling_reference`` on the CPU, forward and
    reverse, at f32 and bf16, and its fake implementation's shapes.
  * The artifact (``tools/export_rollout.py``, ``tools/artifact.py``) of a
    tiny f32 model, exported by both packages on shared weights: a JAX
    Orbax checkpoint of a perturbed init, carried to the port by
    ``tools/export_to_torch.py``. At tau = 0 the draws are multiplied by
    zero, so the two artifacts' means agree within 1e-4 x max(1, max
    |ref|) and both variances vanish. At tau = 0.7 the port's artifact
    equals the port's ``make_ensemble_rollout`` on
    ``Generator().manual_seed(7)``, denormalized, within 1e-6 x max(1, max
    |ref|). The sidecars hold the same keys and values (the port adds
    ``torch_version``; ``platforms`` names each package's device).
  * The server (``tools/serve.py``): batch mode, HTTP mode (400 on a bad
    payload, then still serving), the unchanged ``examples/serve_client.py``
    against it, the calibrated variance, the loader's refusals, and a
    subprocess that serves with no model, data, training, evaluation or
    CLI module of the port loaded, and no JAX.
"""

import dataclasses
import importlib.util
import io
import json
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.cli import parse_args as j_parse_args
from tpuflow.data.dataset import load_dataset as j_load_dataset
from tpuflow.models.tmglow import TMGlow as JTMGlow
from tpuflow.models.tmglow import init_lstm_state as j_init_lstm_state
from tpuflow.tools.artifact import load_artifact as j_load_artifact
from tpuflow.tools.export_rollout import main as j_export_main
from tpuflow.train.checkpoint import Checkpointer as JCheckpointer
from tpuflow.train.step import make_optimizer as j_make_optimizer
from tpuflow_torch.configs import parse_cli_overrides
from tpuflow_torch.data import load_dataset
from tpuflow_torch.eval import load_eval_bundle, make_ensemble_rollout
from tpuflow_torch.kernels import ops
from tpuflow_torch.kernels.coupling_fused import fused_coupling_reference, pack_net
from tpuflow_torch.tools import export_rollout
from tpuflow_torch.tools.artifact import load_artifact
from tpuflow_torch.tools.serve import RolloutServer, build_parser, make_http_server, run_batch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASE = "backward-step"
TINY = [
    "model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
    "model.coupling_layers=2", "model.growth_rate=4", "model.encoder_width=8",
    "model.lstm_hidden=8", "model.cond_channels=8", "model.hf_shape=16,32",
    "model.lf_shape=4,8", "model.compute_dtype=float32",
    "data.n_train_traj=2", "data.n_test_traj=1", "data.train_steps=6",
    "eval.rollout_steps=6", "eval.n_samples=4",
]
TOL_JAX, TOL_SELF = 1e-4, 1e-6
METRICS = {"spread_scale": 2.0, "interval_scales": {"0.50": 1.5, "0.95": 2.5}}


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_to_torch", ROOT / "tools" / "export_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shared_checkpoints(root: pathlib.Path, overrides: list[str]) -> tuple[str, str]:
    """A perturbed init of the model ``overrides`` configure, saved as a JAX
    Orbax checkpoint under ``root/jax`` (with the train split's
    normalization) and carried to the port under ``root/port`` by
    ``tools/export_to_torch.py``; returns the two ``train.checkpoint_dir``."""
    jdir, pdir = root / "jax", root / "port"
    jcfg = j_parse_args([CASE, *overrides, f"train.checkpoint_dir={jdir}"])
    mc = jcfg.model
    jm = JTMGlow(mc)
    v = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, *mc.hf_shape, mc.channels)),
        jnp.zeros((1, *mc.lf_shape, mc.channels)), j_init_lstm_state(mc, (1,))))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), v["params"])
    t = jcfg.train
    opt = j_make_optimizer(t.lr, t.lr_decay, t.grad_clip, t.weight_decay)
    norm = j_load_dataset(jcfg.data, mc, "train").norm
    ck = JCheckpointer(jdir / CASE)
    ck.save(1, {"params": params, "buffers": v["buffers"], "opt_state": opt.init(params),
                "norm": norm.to_dict()},
            meta={"epoch": 1, "global_step": 1, "config": dataclasses.asdict(jcfg)})
    ck.close()
    _exporter().export(CASE, jdir, pdir, overrides=parse_cli_overrides(overrides))
    return str(jdir), str(pdir)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' artifacts of the shared tiny model, exported after
    the case was "evaluated" (an eval_metrics.json with fitted factors)."""
    root = tmp_path_factory.mktemp("serve")
    jdir, pdir = shared_checkpoints(root, TINY)
    out = {}
    for name, ckpt in (("jax", jdir), ("port", pdir)):
        case_dir = root / f"eval_{name}" / CASE
        case_dir.mkdir(parents=True)
        (case_dir / "eval_metrics.json").write_text(json.dumps(METRICS))
        args = [CASE, *TINY, f"train.checkpoint_dir={ckpt}", f"eval.output_dir={root}/eval_{name}"]
        out[name] = (j_export_main([*args, "export_platforms=cpu"]) if name == "jax"
                     else export_rollout.main([*args, "--device", "cpu"]))
    cfg, _ = export_rollout.parse_args([CASE, *TINY, f"train.checkpoint_dir={pdir}"])
    model, norm, _ = load_eval_bundle(cfg, device="cpu")
    ds = load_dataset(cfg.data, cfg.model, "test", norm=norm)
    return dict(root=root, jax=out["jax"], port=out["port"], model=model, ds=ds,
                lf=ds.lf[0, :6].copy())


# ---------------------------------------------------------------- the operator


def _coupling(dtype, h0c_batch):
    g = torch.Generator().manual_seed(0)
    b, h, w, ca, width, growth, layers = 2, 4, 8, 3, 8, 4, 2
    total0 = layers * growth + 2 * ca
    lec = lambda co, ci: torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5  # noqa: E731
    net = pack_net(lec(width, ca), torch.randn(width, generator=g),
                   [lec(total0 - j * growth, width if j == 0 else growth)
                    for j in range(layers + 1)],
                   torch.randn(total0, generator=g), dtype)
    xa, xb = torch.randn(b, h, w, ca, generator=g), torch.randn(b, h, w, ca, generator=g)
    h0c = torch.randn(h0c_batch, h, w, width, generator=g).to(dtype) if h0c_batch else None
    return xa, xb, h0c, net


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0c_batch", [0, 1, 2])
def test_op_is_bit_equal_to_the_plain_version_on_the_cpu(dtype, h0c_batch):
    xa, xb, h0c, net = _coupling(dtype, h0c_batch)
    for reverse in (False, True):
        y, ld = ops.fused_coupling(xa, xb, h0c, net, reverse=reverse)
        y_ref, ld_ref = fused_coupling_reference(xa, xb, h0c, net, reverse=reverse)
        assert torch.equal(y, y_ref) and torch.equal(ld, ld_ref)


def test_op_schema_and_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    xa, xb, h0c, net = _coupling(torch.float32, 1)
    args = (xa, xb, h0c, net.win0, net.b0, list(net.wjs), net.bj0, True)
    torch.library.opcheck(torch.ops.tpuflow_torch.fused_coupling.default, args)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                [mode.from_tensor(t) for t in a] if isinstance(a, list) else a for a in args]
        y, ld = torch.ops.tpuflow_torch.fused_coupling(*fake)
    assert tuple(y.shape) == (2, 4, 8, 6) and tuple(ld.shape) == (2,)
    assert y.dtype == ld.dtype == torch.float32 and y.device == xa.device
    # The rollout's packed path goes through the operator.
    from tpuflow_torch.flows import coupling

    assert coupling.fused_coupling is ops.fused_coupling


# ---------------------------------------------------------------- the artifact


def test_artifact_matches_jax_at_tau_zero(served):
    lf = served["lf"]
    zero = np.zeros((2,), np.float32)
    want = {k: np.asarray(v) for k, v in
            j_load_artifact(served["jax"]).call(lf, np.uint32(3), zero).items()}
    got = {k: v.numpy() for k, v in load_artifact(served["port"])(lf, 3, zero).items()}
    assert got["mean"].shape == want["mean"].shape == (6, 16, 32, 3)
    scale = max(1.0, float(np.abs(want["mean"]).max()))
    np.testing.assert_allclose(got["mean"], want["mean"], rtol=0, atol=TOL_JAX * scale)
    assert float(np.abs(want["var"]).max()) < 1e-8
    assert float(np.abs(got["var"]).max()) < 1e-8


def test_artifact_equals_the_ports_rollout(served):
    tau = torch.full((2,), 0.7)
    program = load_artifact(served["port"], "cpu")
    # The packed nets and inverse 1x1 convs load as constants: the CUDA
    # kernel's wrapper refuses inputs that require grad.
    assert not any(b.requires_grad for b in program.step.buffers())
    got = program(served["lf"], 7, tau)
    ds = served["ds"]
    ref = make_ensemble_rollout(served["model"], 4, tau, "stats")(
        torch.from_numpy(served["lf"]), torch.Generator().manual_seed(7))
    for k, want in (("mean", ds.denorm_hf(ref["mean"])), ("var", ds.denorm_hf_var(ref["var"]))):
        scale = max(1.0, want.abs().max().item())
        assert torch.isfinite(got[k]).all()
        assert (got[k] - want).abs().max().item() <= TOL_SELF * scale, k
    assert float(got["var"].min()) >= 0 and float(got["var"].max()) > 0


def test_sidecar_matches_jax(served):
    want = json.loads(served["jax"].with_suffix(".meta.json").read_text())
    got = json.loads(served["port"].with_suffix(".meta.json").read_text())
    assert served["port"].name == "rollout.torchexport"
    assert set(got) == set(want) | {"torch_version"}
    assert got["platforms"] == ["cpu"] and got["torch_version"] == torch.__version__
    for k in set(want) - {"platforms"}:
        assert got[k] == want[k], k
    assert got["spread_scale"] == 2.0 and got["interval_scales"]["0.95"] == 2.5


# ---------------------------------------------------------------- the server


def test_batch_http_and_the_client(served, tmp_path):
    server = RolloutServer(served["port"], device="cpu")
    direct = load_artifact(served["port"])(served["lf"], 7, np.full((2,), 0.7, np.float32))
    direct = {k: v.numpy() for k, v in direct.items()}
    lf_phys = served["ds"].denorm_lf(served["lf"])
    got = server.rollout(lf_phys, seed=7)  # the sidecar's default tau, 0.7
    np.testing.assert_allclose(got["mean"], direct["mean"], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exported contract"):
        server.rollout(lf_phys[:3], seed=7)
    cal = server.rollout(lf_phys, seed=7, calibrated=True)
    np.testing.assert_array_equal(cal["mean"], got["mean"])
    np.testing.assert_allclose(cal["var"], 4.0 * got["var"], rtol=1e-6)

    inp = tmp_path / "lf.npz"
    np.savez(inp, lf=lf_phys)
    run_batch(build_parser().parse_args([
        "batch", "--artifact", str(served["port"]), "--input", str(inp),
        "--output", str(tmp_path / "stats.npz"), "--seed", "7", "--device", "cpu"]))
    with np.load(tmp_path / "stats.npz") as saved:
        np.testing.assert_array_equal(saved["mean"], got["mean"])
        np.testing.assert_array_equal(saved["var"], got["var"])

    httpd = make_http_server(server, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        health = json.loads(urllib.request.urlopen(f"{url}/healthz", timeout=30).read())
        assert health == server.meta
        buf = io.BytesIO()
        np.savez(buf, lf=lf_phys)
        req = urllib.request.Request(f"{url}/rollout?seed=7", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            assert len(body) == int(resp.headers["Content-Length"])
        with np.load(io.BytesIO(body)) as out:
            np.testing.assert_array_equal(out["mean"], got["mean"])
        bad = urllib.request.Request(f"{url}/rollout", data=b"junk", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400
        with urllib.request.urlopen(req, timeout=120) as resp:  # still serving
            assert resp.status == 200

        # The JAX package's client, unchanged, against the port's server.
        spec = importlib.util.spec_from_file_location(
            "serve_client", ROOT / "examples" / "serve_client.py")
        client = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(client)
        out = client.main(["--url", url, "--lf", str(inp), "--seed", "7",
                           "--out", str(tmp_path / "client.npz")])
        np.testing.assert_array_equal(out["mean"], got["mean"])
        synth = client.main(["--url", url, "--seed", "3", "--calibrated"])
        assert synth["mean"].shape == got["mean"].shape and np.isfinite(synth["mean"]).all()
    finally:
        httpd.shutdown()


def test_loader_refuses_another_device_and_torch(served, tmp_path):
    with pytest.raises(ValueError, match="exported on cpu and cannot serve on cuda"):
        load_artifact(served["port"], "cuda")
    other = tmp_path / "other.torchexport"
    with zipfile.ZipFile(served["port"]) as src, zipfile.ZipFile(other, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename == "program.json":
                program = json.loads(data)
                program["torch_version"] = "2.11.0+cu128"
                data = json.dumps(program).encode()
            dst.writestr(item, data)
    with pytest.raises(RuntimeError, match=r"exported with torch 2\.11\.0\+cu128"):
        load_artifact(other)
    if not torch.cuda.is_available():  # the server asks for the GPU by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RolloutServer(served["port"])


def test_server_host_imports_no_model_code(served):
    probe = (
        "import sys\n"
        "for m in ('jax', 'tpuflow'):\n"
        "    sys.modules[m] = None  # importing either would raise\n"
        "import numpy as np\n"
        "from tpuflow_torch.tools.serve import RolloutServer\n"
        f"s = RolloutServer({str(served['port'])!r}, device='cpu')\n"
        "out = s.rollout(np.zeros(tuple(s.meta['lf_input_shape']), np.float32))\n"
        "assert np.isfinite(out['mean']).all()\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[:2] in [\n"
        "    ['tpuflow_torch', p] for p in ('models', 'eval', 'train', 'data', 'cli')])\n"
        "print('HEAVY:' + ','.join(heavy))\n"
    )
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "HEAVY:", res.stdout
