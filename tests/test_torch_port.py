"""Rules of the port: the weight bridge refuses a tree that does not fit,
``tpuflow_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
package, and entry points refuse to run on the CPU unasked.
"""

import ast
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpuflow_torch.configs import ModelConfig
from tpuflow_torch.convert import from_flax
from tpuflow_torch.flows import ActNorm, AffineCoupling
from tpuflow_torch.models import TMGlow

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "tpuflow_torch"


def _coupling_tree(cb=2, width=4, growth=2, cc=3):
    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"params": {"net": {
        "conv_in_0": {"kernel": r(3, 3, cb, width), "bias": r(width)},
        "conv_in_1": {"kernel": r(3, 3, cc, width)},
        "joint_0": {"kernel": r(3, 3, width, growth + 2 * cb), "bias": r(growth + 2 * cb)},
        "joint_1": {"kernel": r(3, 3, growth, 2 * cb)},
    }}}


def _coupling():
    return AffineCoupling(4, 3, width=4, layers=1, growth_rate=2, dtype=torch.float32)


def test_bridge_maps_hwio_to_oihw():
    tree = _coupling_tree()
    m = _coupling()
    m.load_state_dict(from_flax(tree, m))
    k = tree["params"]["net"]["joint_0"]["kernel"]
    np.testing.assert_array_equal(
        m.net.joint_0.weight.detach().numpy(), np.transpose(k, (3, 2, 0, 1)))


def test_bridge_raises_on_missing_key():
    tree = _coupling_tree()
    del tree["params"]["net"]["joint_1"]
    with pytest.raises(KeyError, match=r"missing keys \['net.joint_1.weight'\]"):
        from_flax(tree, _coupling())


def test_bridge_raises_on_unused_key():
    tree = _coupling_tree()
    tree["params"]["net"]["joint_2"] = {"kernel": np.zeros((3, 3, 2, 4), np.float32)}
    with pytest.raises(KeyError, match=r"unused keys \['net.joint_2.weight'\]"):
        from_flax(tree, _coupling())


def test_bridge_raises_on_shape_and_collection():
    tree = {"params": {"bias": np.zeros(3, np.float32), "log_scale": np.zeros(4, np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        from_flax(tree, ActNorm(4))
    with pytest.raises(KeyError, match="collections"):
        from_flax({"params": {}, "batch_stats": {}}, ActNorm(4))


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    )


def test_package_imports_without_jax():
    """Every module imports with jax (and flax) blocked."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'tpuflow'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_tpuflow_import_in_sources():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "examples" / "quickstart_torch.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "tpuflow"), (path, name)


def test_default_device_entry_point_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg = ModelConfig(n_scales=1, n_flow_steps=1, hf_shape=(4, 4), lf_shape=(2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TMGlow(cfg)
    assert TMGlow(cfg, device="cpu").device.type == "cpu"
    # The fine-tune tool resolves its device before it reads anything.
    from tpuflow_torch.tools.finetune import main as finetune_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune_main(["backward-step", "train.checkpoint_dir=/nonexistent"])
    # So do the converter, the oracle's generator and the walkthrough.
    from tpuflow_torch.tools.convert_torch import main as convert_main
    from tpuflow_torch.tools.make_eval_oracle import main as oracle_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_main(["/nonexistent.pt", "/nonexistent", "backward-step"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        oracle_main([])
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main(["/nonexistent"])
