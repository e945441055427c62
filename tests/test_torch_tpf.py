"""The port's .tpf store (``tpuflow_torch.data.tpf``) against the JAX
package's (``tpuflow.data.tpf``) as the reference, on the native loader
and on the NumPy memmap path: the same bytes written, a store written by
either package read in the other, the same gathers (plain, normalized,
async), the same prefetched windows and streamed normalization, the
streaming dataset equal to the RAM one, bad magic refused, and closing
with gathers in flight safe. Then training: a streamed epoch of the port
equals a RAM epoch, a resume takes the checkpoint's constants without
the normalization sweep, and ``data.loader=stream`` finds the store.

Every comparison of read data is exact except where the normalization
is fused (1e-6, the JAX package's own tolerance) and the streamed
moments (float64 sums against NumPy's, 1e-5)."""

import numpy as np
import pytest
import torch

import tpuflow.data.tpf as jtpf
import tpuflow_torch.data.tpf as ttpf
from tpuflow_torch.configs import load_case
from tpuflow_torch.data import NormStats, TrajectoryDataset, load_dataset, save_archive
from tpuflow_torch.kernels._build import BUILD_DIR
from tpuflow_torch.train import Trainer

torch.set_num_threads(1)

N, T, C = 5, 12, 3
LF_HW, HF_HW = (4, 8), (8, 16)
NATIVE = pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    lf = rng.normal(size=(N, T, *LF_HW, C)).astype(np.float32)
    hf = rng.normal(loc=1.5, scale=2.0, size=(N, T, *HF_HW, C)).astype(np.float32)
    return lf, hf


@pytest.fixture()
def store_path(arrays, tmp_path):
    return ttpf.save_tpf(tmp_path / "case_train.tpf", *arrays)


def test_native_loader_builds_into_the_build_dir():
    """g++ is on this machine: the port's own loader.cpp builds, into
    build/tpuflow_torch/ under a hashed name."""
    assert ttpf._build_lib() is not None
    path = ttpf.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libtpfloader-") and len(path.stem.split("-")[1]) == 16


def test_save_tpf_writes_the_jax_bytes(arrays, tmp_path):
    got = ttpf.save_tpf(tmp_path / "port.tpf", *arrays)
    want = jtpf.save_tpf(tmp_path / "jax.tpf", *arrays)
    assert got.read_bytes() == want.read_bytes()
    with pytest.raises(ValueError, match="5-D"):
        ttpf.save_tpf(tmp_path / "bad.tpf", arrays[0][0], arrays[1][0])


@NATIVE
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_reads_match_jax_either_writer(arrays, tmp_path, use_native, writer):
    lf, hf = arrays
    path = (ttpf if writer == "port" else jtpf).save_tpf(tmp_path / "s.tpf", lf, hf)
    with ttpf.TPFStore(path, use_native=use_native) as s, \
            jtpf.TPFStore(path, use_native=use_native) as j:
        assert s.native == use_native == j.native
        assert (s.n_traj, s.n_steps, s.lf_shape, s.hf_shape) == (
            j.n_traj, j.n_steps, j.lf_shape, j.hf_shape)
        for which, ids, t0, t1 in (("hf", [3, 0], 2, 7), ("lf", np.arange(N), 0, T)):
            got = s.read_batch(which, ids, t0, t1)
            np.testing.assert_array_equal(got, j.read_batch(which, ids, t0, t1))
            np.testing.assert_array_equal(got, (lf, hf)[which == "hf"][ids, t0:t1])


@NATIVE
def test_fused_normalization_matches_jax(arrays, store_path, use_native):
    lf, hf = arrays
    norm = NormStats.from_data(lf, hf)
    with ttpf.TPFStore(store_path, use_native=use_native) as s, \
            jtpf.TPFStore(store_path, use_native=use_native) as j:
        got = s.read_batch("hf", [1, 4], 0, T, norm.hf_mean, norm.hf_std)
        np.testing.assert_array_equal(
            got, j.read_batch("hf", [1, 4], 0, T, norm.hf_mean, norm.hf_std))
    np.testing.assert_allclose(got, (hf[[1, 4]] - norm.hf_mean) / norm.hf_std, atol=1e-6)


@NATIVE
def test_async_matches_sync(arrays, store_path, use_native):
    lf, _ = arrays
    norm = NormStats.from_data(*arrays)
    with ttpf.TPFStore(store_path, use_native=use_native) as s:
        tickets = [s.read_batch_async("lf", [i, (i + 2) % N], 1, 9, norm.lf_mean, norm.lf_std)
                   for i in range(N)]
        for i, t in enumerate(tickets):
            np.testing.assert_array_equal(
                t.wait(), s.read_batch("lf", [i, (i + 2) % N], 1, 9, norm.lf_mean, norm.lf_std))
        raw = s.read_batch_async("lf", [2], 0, 4)
        assert raw.wait() is raw.wait()  # idempotent
        np.testing.assert_array_equal(raw.wait()[0], lf[2, :4])


@NATIVE
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_prefetching_window_loader_matches_jax_and_ram(arrays, store_path, use_native,
                                                      drop_remainder):
    lf, hf = arrays
    ram = TrajectoryDataset(lf, hf)
    window, batch, seed = 4, 2, 7
    with ttpf.TPFStore(store_path, use_native=use_native) as s, \
            jtpf.TPFStore(store_path, use_native=use_native) as j:
        got = list(ttpf.PrefetchingWindowLoader(s, window, batch, ram.norm,
                                                drop_remainder).epoch(seed))
        want = list(jtpf.PrefetchingWindowLoader(j, window, batch, ram.norm,
                                                 drop_remainder).epoch(seed))
    assert len(got) == len(want) > 0
    for (lf_g, hf_g, f_g), (lf_w, hf_w, f_w) in zip(got, want):
        assert f_g == f_w
        np.testing.assert_array_equal(lf_g, lf_w)
        np.testing.assert_array_equal(hf_g, hf_w)
    expect = [(lf_w, hf_w, i == 0)
              for lf_b, hf_b in ram.traj_batches(seed, batch, drop_remainder)
              for i, (lf_w, hf_w) in enumerate(TrajectoryDataset.windows(lf_b, hf_b, window))]
    assert len(got) == len(expect)
    for (lf_g, hf_g, f_g), (lf_e, hf_e, f_e) in zip(got, expect):
        assert f_g == f_e
        np.testing.assert_allclose(lf_g, lf_e, atol=1e-6)
        np.testing.assert_allclose(hf_g, hf_e, atol=1e-6)
    n_traj = sum(b[0].shape[0] for b in got if b[2])
    assert n_traj == (N if not drop_remainder else N // batch * batch)


@NATIVE
def test_norm_and_streaming_dataset_match_jax_and_ram(arrays, store_path, use_native):
    lf, hf = arrays
    ram = TrajectoryDataset(lf, hf)
    with ttpf.TPFStore(store_path, use_native=use_native) as s, \
            jtpf.TPFStore(store_path, use_native=use_native) as j:
        norm = ttpf.compute_norm_streaming(s)
        norm_j = jtpf.compute_norm_streaming(j)
        for k, v in norm.to_dict().items():
            np.testing.assert_array_equal(v, getattr(norm_j, k))
            np.testing.assert_allclose(v, getattr(ram.norm, k), rtol=1e-5, atol=1e-5)
        stream = ttpf.StreamingTrajectoryDataset(s, norm=ram.norm)
        stream_j = jtpf.StreamingTrajectoryDataset(j, norm=ram.norm)
        assert (stream.n_traj, stream.n_steps) == (ram.n_traj, ram.n_steps)
        got = list(stream.traj_batches(3, 2))
        want_j = list(stream_j.traj_batches(3, 2))
        want = list(ram.traj_batches(3, 2))
        assert len(got) == len(want) == len(want_j) > 0
        for (lf_g, hf_g), (lf_j, hf_j), (lf_w, hf_w) in zip(got, want_j, want):
            np.testing.assert_array_equal(lf_g, lf_j)
            np.testing.assert_array_equal(hf_g, hf_j)
            np.testing.assert_allclose(lf_g, lf_w, atol=1e-6)
            np.testing.assert_allclose(hf_g, hf_w, atol=1e-6)
        # A rank's rows of each batch, as the trainer asks for them.
        half = list(stream.traj_batches(3, 2, rows=slice(1, 2)))
        for (lf_h, hf_h), (lf_g, hf_g) in zip(half, got):
            np.testing.assert_array_equal(lf_h, lf_g[1:2])
            np.testing.assert_array_equal(hf_h, hf_g[1:2])
        assert len(list(stream.windows(got[0][0], got[0][1], 4))) == T // 4
        np.testing.assert_allclose(stream.denorm_hf(got[0][1][:, 0]),
                                   ram.denorm_hf(want[0][1][:, 0]), atol=1e-5)
        np.testing.assert_allclose(stream.denorm_hf_var(np.ones(C, np.float32)),
                                   ram.norm.hf_std**2, rtol=1e-6)


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "x.tpf"
    p.write_bytes(b"NOPE" + b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        ttpf.TPFStore(p)


def test_close_with_gathers_in_flight(arrays, store_path):
    """An abandoned prefetching generator, then closing the store, is safe;
    racing the native close against 64 queued gathers resolves every
    ticket with the right bytes or a clean IOError."""
    import threading

    lf, hf = arrays
    with ttpf.TPFStore(store_path) as s:
        ds = ttpf.StreamingTrajectoryDataset(s, norm=NormStats.from_data(lf, hf))
        gen = ds.traj_batches(0, 2)
        next(gen)  # the next batch's gather stays in flight
        del gen
    with ttpf.TPFStore(store_path) as s2:
        np.testing.assert_array_equal(s2.read_batch("lf", [1], 0, 3)[0], lf[1, :3])
    s = ttpf.TPFStore(store_path)
    assert s.native
    tickets = [s.read_batch_async("hf", [i % N], 0, T) for i in range(64)]
    closer = threading.Thread(target=s._lib.tpf_close, args=(s._handle,))
    closer.start()
    ok = failed = 0
    for i, t in enumerate(tickets):
        try:
            np.testing.assert_array_equal(t.wait()[0], hf[i % N])
            ok += 1
        except IOError:
            failed += 1
    closer.join(timeout=60)
    assert not closer.is_alive()
    s._handle = 0  # closed directly above
    s._pending.clear()
    assert ok + failed == 64


def test_streaming_norm_is_lazy_and_assignable(arrays, store_path, monkeypatch):
    def boom(store, chunk=4):
        raise AssertionError("the normalization sweep must not run")

    monkeypatch.setattr(ttpf, "compute_norm_streaming", boom)
    with ttpf.TPFStore(store_path) as s:
        ds = ttpf.StreamingTrajectoryDataset(s)
        ds.norm = NormStats.from_data(*arrays)
        next(ds.traj_batches(0, 2))


# ------------------------------------------------------------ training

TINY_ARGS = {
    "model.n_scales": 2, "model.n_flow_steps": 2, "model.coupling_width": 8,
    "model.coupling_layers": 2, "model.growth_rate": 4, "model.encoder_width": 8,
    "model.lstm_hidden": 8, "model.cond_channels": 8, "model.hf_shape": "16,32",
    "model.lf_shape": "4,8", "model.compute_dtype": "float32",
    "data.batch_size": 2, "data.window": 2, "data.train_steps": 4, "train.log_every": 0,
}


@pytest.fixture()
def stream_dir(tmp_path):
    from tpuflow_torch.data import generate_case

    lf, hf = generate_case("backward-step", 4, 4, (16, 32), (4, 8), seed=3)
    ttpf.save_tpf(tmp_path / "d" / "backward-step_train.tpf", lf, hf)
    return tmp_path, lf, hf


def _cfg(tmp_path, **extra):
    return load_case("backward-step", {**TINY_ARGS, "data.synthetic": False,
                                       "data.data_dir": str(tmp_path / "d"),
                                       "train.checkpoint_dir": str(tmp_path / "ckpt"), **extra})


def test_streamed_epoch_equals_ram_epoch(stream_dir):
    """A Trainer on the StreamingTrajectoryDataset (never device-resident)
    trains an epoch equal, bit for bit, to the same epoch from RAM,
    resident or uploaded per batch. The constants' stds are powers of two,
    so the store's fused (x - mean) * (1 / std) rounds as RAM's
    (x - mean) / std does; the streamed constants are held to NumPy's
    above."""
    tmp_path, lf, hf = stream_dir
    norm = NormStats(lf_mean=lf.mean(axis=(0, 1, 2, 3)), lf_std=np.array([1, 2, 4], np.float32),
                     hf_mean=hf.mean(axis=(0, 1, 2, 3)), hf_std=np.array([2, 1, 0.5], np.float32))
    cfg = _cfg(tmp_path, **{"data.loader": "stream", "train.epochs": 1})
    stream = load_dataset(cfg.data, cfg.model, "train", norm=norm)
    assert isinstance(stream, ttpf.StreamingTrajectoryDataset)
    results = {}
    for name, ds, resident in (("stream", stream, True),
                               ("ram", TrajectoryDataset(lf, hf, norm), True),
                               ("upload", TrajectoryDataset(lf, hf, norm), False)):
        c = _cfg(tmp_path / name, **{"train.epochs": 1, "data.device_resident": resident})
        trainer = Trainer(c, dataset=ds, device="cpu")
        assert trainer._resident == (name == "ram")
        trainer.init_or_resume()
        results[name] = (trainer.run(), dict(trainer.model.state_dict()))
    (m_s, p_s), (m_r, p_r), (m_u, p_u) = results["stream"], results["ram"], results["upload"]
    assert m_s["epoch"] == 1 and np.isfinite(m_s["mean_bpd"])
    assert m_s["mean_bpd"] == m_r["mean_bpd"] == m_u["mean_bpd"]
    for k, v in p_r.items():
        assert torch.equal(p_s[k], v) and torch.equal(p_u[k], v), k


def test_stream_resume_takes_the_checkpoint_norm(stream_dir, monkeypatch):
    tmp_path, lf, hf = stream_dir
    from tpuflow_torch.cli.train import main as train_main

    args = ["backward-step", *[f"{k}={v}" for k, v in TINY_ARGS.items()],
            "data.synthetic=false", "data.loader=stream", f"data.data_dir={tmp_path / 'd'}",
            f"train.checkpoint_dir={tmp_path / 'ckpt'}", "--device", "cpu"]
    first = train_main([*args, "train.epochs=1"])
    assert first["epoch"] == 1

    def boom(store, chunk=4):
        raise AssertionError("a resume must not sweep the store")

    monkeypatch.setattr(ttpf, "compute_norm_streaming", boom)
    second = train_main([*args, "train.epochs=2"])
    assert second["epoch"] == 2 and np.isfinite(second["mean_bpd"])


def test_stream_loader_finds_the_store_next_to_an_archive(stream_dir):
    tmp_path, lf, hf = stream_dir
    save_archive(tmp_path / "d" / "backward-step_train.h5", lf, hf)
    cfg = _cfg(tmp_path, **{"data.loader": "stream"})
    assert isinstance(load_dataset(cfg.data, cfg.model, "train"), ttpf.StreamingTrajectoryDataset)
    (tmp_path / "d" / "backward-step_train.tpf").unlink()
    with pytest.raises(FileNotFoundError, match="tpuflow_torch.tools.convert_tpf"):
        load_dataset(cfg.data, cfg.model, "train")
