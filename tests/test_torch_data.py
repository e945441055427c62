"""The port's archives and data tools against the JAX package's:
``load_archive``/``save_archive`` across the two packages (.h5, .hdf5,
.npz, .tpf; bit-equal both ways), ``find_archive``'s order, the
``data.loader`` errors, a missing ``h5py``, and ``tools/convert_tpf`` and
``tools/inspect_data`` (report, ``--json`` record, ``--import``) against
the JAX tools' outputs on the same files."""

import itertools
import json
import sys

import numpy as np
import pytest

from tpuflow.data.dataset import _find_archive as j_find_archive
from tpuflow.data.dataset import load_archive as j_load_archive
from tpuflow.data.dataset import save_archive as j_save_archive
from tpuflow.tools import convert_tpf as j_convert_tpf
from tpuflow.tools import inspect_data as j_inspect
from tpuflow_torch.configs import load_case
from tpuflow_torch.data import generate_case, load_archive, load_dataset, save_archive
from tpuflow_torch.data.dataset import find_archive
from tpuflow_torch.tools import convert_tpf, inspect_data

SUFFIXES = [".h5", ".hdf5", ".npz", ".tpf"]


@pytest.fixture(scope="module")
def arrays():
    return generate_case("backward-step", 2, 4, (32, 64), (8, 16), seed=3)


@pytest.mark.parametrize("suffix", SUFFIXES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archives_cross_between_packages(arrays, tmp_path, suffix, writer):
    lf, hf = arrays
    path = tmp_path / f"a{suffix}"
    (j_save_archive if writer == "jax" else save_archive)(path, lf, hf)
    for load in (load_archive, j_load_archive):
        got_lf, got_hf = load(path)
        assert got_lf.dtype == lf.dtype and got_hf.dtype == hf.dtype
        np.testing.assert_array_equal(got_lf, lf)
        np.testing.assert_array_equal(got_hf, hf)


def test_unsupported_suffix(tmp_path):
    with pytest.raises(ValueError, match="unsupported archive"):
        load_archive(tmp_path / "a.zarr")
    with pytest.raises(ValueError, match="unsupported archive"):
        save_archive(tmp_path / "a.zarr", np.zeros(1), np.zeros(1))


@pytest.mark.parametrize("present", [c for n in range(1, 5)
                                     for c in itertools.combinations(SUFFIXES, n)],
                         ids=lambda c: "+".join(s[1:] for s in c))
def test_find_archive_order_matches_jax(tmp_path, present):
    for suffix in present:
        (tmp_path / f"backward-step_test{suffix}").write_bytes(b"")
    assert find_archive(tmp_path, "backward-step", "test") == j_find_archive(
        tmp_path, "backward-step", "test")
    with pytest.raises(FileNotFoundError, match=r"\(h5\|hdf5\|npz\|tpf\)"):
        find_archive(tmp_path, "backward-step", "train")


def test_load_dataset_reads_each_format_and_loader_errors(arrays, tmp_path):
    lf, hf = arrays
    base = {"data.synthetic": False, "data.data_dir": str(tmp_path),
            "model.hf_shape": "32,64", "model.lf_shape": "8,16"}
    save_archive(tmp_path / "backward-step_train.hdf5", lf, hf)
    save_archive(tmp_path / "backward-step_test.tpf", lf[:1], hf[:1])
    cfg = load_case("backward-step", base)
    train, test = load_dataset(cfg.data, cfg.model), load_dataset(cfg.data, cfg.model, "test")
    np.testing.assert_array_equal(train.norm.hf_mean, test.norm.hf_mean)
    np.testing.assert_allclose(test.denorm_hf(test.hf), hf[:1], rtol=1e-5, atol=1e-5)
    bad = load_case("backward-step", {**base, "data.loader": "mmap"})
    with pytest.raises(ValueError, match="unknown data.loader 'mmap'"):
        load_dataset(bad.data, bad.model)
    stream = load_case("backward-step", {**base, "data.loader": "stream"})
    with pytest.raises(FileNotFoundError, match="data.loader=stream needs"):
        load_dataset(stream.data, stream.model)
    # The stream loader serves the train split only; test reads as in RAM.
    assert load_dataset(stream.data, stream.model, "test").n_traj == 1


def test_h5_without_h5py_names_the_file(arrays, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match=r"x\.h5: .*needs h5py"):
        save_archive(tmp_path / "x.h5", *arrays)
    with pytest.raises(ImportError, match=r"y\.hdf5: .*needs h5py"):
        load_archive(tmp_path / "y.hdf5")


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_convert_tpf_matches_jax_tool(arrays, tmp_path, capsys, suffix):
    src = tmp_path / f"a{suffix}"
    save_archive(src, *arrays)
    assert convert_tpf.main([str(src), str(tmp_path / "port.tpf")]) == 0
    assert j_convert_tpf.main([str(src), str(tmp_path / "jax.tpf")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("port", "jax") == out[1]
    assert (tmp_path / "port.tpf").read_bytes() == (tmp_path / "jax.tpf").read_bytes()
    with pytest.raises(SystemExit):
        convert_tpf.main([str(src), str(tmp_path / "x.npz")])


def _archives(tmp_path):
    """(name, path) of a good archive and each malformed one of the JAX
    tool's tests."""
    lf, hf = generate_case("backward-step", 2, 4, (32, 64), (8, 16), seed=3)
    out = []

    def put(name, a, b, save=save_archive):
        p = tmp_path / name
        save(p, a, b)
        out.append(p)

    put("ok.npz", lf, hf)
    put("ok.tpf", lf, hf)
    bad = np.zeros((2, 3, 30, 62, 3), np.float32)
    bad[0, 0, 0, 0, 0] = np.nan
    put("bad.npz", np.zeros((2, 4, 8, 16, 3), np.float32), bad)
    put("4d.npz", np.zeros((4, 8, 16, 3), np.float32), np.zeros((4, 32, 64, 3), np.float32),
        save=lambda p, a, b: np.savez_compressed(p, lf=a, hf=b))
    rng = np.random.default_rng(0)
    put("swapped.npz", rng.random((1, 2, 16, 32, 3), dtype=np.float32),
        rng.random((1, 2, 8, 16, 3), dtype=np.float32))
    put("empty.npz", np.zeros((0, 4, 8, 16, 3), np.float32), np.zeros((0, 4, 32, 64, 3),
                                                                       np.float32))
    put("channels.h5", lf[..., :2], hf[..., :2])
    return out


@pytest.mark.parametrize("n_scales", [2, 3])
def test_inspect_data_matches_jax_tool(tmp_path, capsys, n_scales):
    """The record (every --json key and value), the report's text and the
    exit code equal the JAX tool's on each archive (records compared as
    JSON, where NaN equals NaN)."""
    for path in _archives(tmp_path):
        got = json.dumps(inspect_data.inspect_archive(path, n_scales=n_scales), sort_keys=True)
        want = json.dumps(j_inspect.inspect_archive(path, n_scales=n_scales), sort_keys=True)
        assert got == want, path.name
        flags = [str(path), f"--n-scales={n_scales}"]
        for extra in ([], ["--json"]):
            rc = inspect_data.main(flags + extra)
            text = capsys.readouterr().out
            assert (rc, text) == (j_inspect.main(flags + extra), capsys.readouterr().out)
        assert json.dumps(json.loads(text), sort_keys=True) == want
    assert inspect_data.main([]) == 2


def test_inspect_data_import_matches_jax_tool(tmp_path, capsys):
    """--import on alien layouts: the same decisions, and an archive the
    JAX tool's would equal."""
    import h5py

    lf, hf = generate_case("backward-step", 2, 6, (32, 64), (8, 16), seed=11)
    src = tmp_path / "dump.h5"
    with h5py.File(src, "w") as f:
        f.create_group("solver/coarse_mesh").create_dataset(
            "fields", data=np.moveaxis(lf, -1, 2))
        f.create_dataset("dns_reference_run", data=hf)
        f.create_dataset("time_values", data=np.arange(6.0))
        f.create_dataset("README", data=np.bytes_(b"not an array"))
    src4 = tmp_path / "single.npz"
    np.savez_compressed(src4, low_res=lf[0], high_res=hf[0])
    for source, out in ((src, "o.h5"), (src4, "o4.npz")):
        got = inspect_data.import_alien(source, tmp_path / f"port_{out}")
        want = j_inspect.import_alien(source, tmp_path / f"jax_{out}")
        strip = lambda r: {k: v for k, v in r.items() if k not in ("out", "inspection")}  # noqa: E731
        assert strip(got) == strip(want) and got["ok"]
        assert {**got["inspection"], "path": ""} == {**want["inspection"], "path": ""}
        for a, b in zip(load_archive(tmp_path / f"port_{out}"),
                        j_load_archive(tmp_path / f"jax_{out}")):
            np.testing.assert_array_equal(a, b)
    assert got["lf_shape"] == [1, 6, 8, 16, 3]
    assert inspect_data.main(["--import", str(src), "--out", str(tmp_path / "c.npz")]) == 0
    printed = capsys.readouterr().out
    assert "lf <- solver/coarse_mesh/fields" in printed and "contract: OK" in printed
    bad = tmp_path / "bad.npz"
    np.savez_compressed(bad, a=np.zeros(7), b=np.zeros((3, 3)))
    with pytest.raises(ValueError, match="plausible trajectory arrays"):
        inspect_data.import_alien(bad, tmp_path / "never.npz")
