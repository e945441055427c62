"""The port's PyTorch-dump converter, ``python -m
tpuflow_torch.tools.convert_torch``, against ``tpuflow.tools.convert_torch``
at a miniature width.

One source file (a state dict in tpuflow's naming, OIHW convs, the
inv-1x1 buffers included) goes through both packages' ``main``. JAX's
checkpoint, mapped by ``tpuflow_torch.convert.from_flax``, equals the
port's state dict tensor for tensor; the normalization constants are
equal; the f32 NLL of one input agrees within 1e-5. Dumps with a missing,
misshapen or unexpected tensor, or without the inv-1x1 buffers, are
refused; ``norm`` comes from the blob when it has one; the output resumes
in ``tpuflow_torch.cli.train``.
"""

import re

import jax
import numpy as np
import pytest
import torch

from tpuflow.cli import parse_args as j_parse_args
from tpuflow.eval.loading import load_eval_bundle as j_load_eval_bundle
from tpuflow.models.tmglow import init_lstm_state as j_init_lstm_state
from tpuflow.tools.convert_torch import main as j_convert_main
from tpuflow_torch.cli import parse_args
from tpuflow_torch.cli.train import main as train_main
from tpuflow_torch.convert import from_flax
from tpuflow_torch.data import load_dataset
from tpuflow_torch.eval import load_eval_bundle
from tpuflow_torch.models import TMGlow, init_lstm_state, perturb_
from tpuflow_torch.tools import convert_torch
from tpuflow_torch.train import Checkpointer

torch.set_num_threads(1)

ARGS = [
    "backward-step",
    "model.n_scales=2", "model.n_flow_steps=2", "model.coupling_width=8",
    "model.coupling_layers=2", "model.growth_rate=4",
    "model.encoder_width=8", "model.lstm_hidden=8",
    "model.cond_channels=8", "model.hf_shape=16,32", "model.lf_shape=4,8",
    "model.compute_dtype=float32", "model.use_pallas=false",
    "data.n_train_traj=2", "data.n_test_traj=1", "data.train_steps=4",
    "data.batch_size=2", "data.window=2", "train.log_every=0",
]
NLL_TOL = 1e-5


def _source_state_dict() -> dict[str, torch.Tensor]:
    """A trained-looking model's state dict in tpuflow's naming: every
    tensor of the port's state dict but ActNorm's ``initialized`` flags,
    which a Flax tree (and so a dump in its naming) has no leaf for."""
    cfg, _ = parse_args(ARGS)
    model = TMGlow(cfg.model, device="cpu", seed=3)
    perturb_(model, 4, scale=0.05)
    return {k: v.clone() for k, v in model.state_dict().items()
            if not k.endswith(".initialized")}


def _convert(tmp_path, blob, name="port", device="cpu"):
    src = tmp_path / f"{name}.pt"
    torch.save(blob, src)
    out = tmp_path / name / "backward-step"
    convert_torch.main([str(src), str(out), *ARGS, f"train.checkpoint_dir={tmp_path / name}",
                        "--device", device])
    return Checkpointer(out).restore(0)


def test_port_converter_matches_the_jax_converter(tmp_path):
    sd = _source_state_dict()
    src = tmp_path / "source.pt"
    torch.save(sd, src)
    j_args = [*ARGS, f"train.checkpoint_dir={tmp_path / 'jax'}"]
    j_convert_main([str(src), str(tmp_path / "jax" / "backward-step"), *j_args])
    got = _convert(tmp_path, sd)

    jcfg = j_parse_args(j_args)
    jmodel, variables, jnorm, _ = j_load_eval_bundle(jcfg)
    cfg, _ = parse_args(ARGS)
    via_flax = from_flax(jax.device_get(variables), TMGlow(cfg.model, device="cpu"))
    assert list(via_flax) == list(got["model"])
    for k, v in via_flax.items():
        assert torch.equal(got["model"][k], v), k
    for k, a in jnorm.to_dict().items():
        np.testing.assert_array_equal(got["norm"][k].numpy(), a)

    # The full trainer format, at step 0 of a fresh optimizer.
    assert set(got) == {"model", "optimizer", "scheduler", "norm", "meta"}
    assert got["optimizer"]["state"] == {} and got["scheduler"]["last_epoch"] == 0
    assert {k: got["meta"][k] for k in ("epoch", "global_step")} == {"epoch": 0, "global_step": 0}
    assert got["meta"]["source"] == str(tmp_path / "port.pt")
    assert got["meta"]["config"]["model"]["coupling_width"] == 8
    assert all(bool(v) for k, v in got["model"].items() if k.endswith(".initialized"))

    # f32 NLL of one input: JAX on its checkpoint, the port on its own.
    rng = np.random.default_rng(0)
    hf = rng.standard_normal((1, 16, 32, 3)).astype(np.float32)
    lf = rng.standard_normal((1, 4, 8, 3)).astype(np.float32)
    want, _ = jmodel.apply(variables, hf, lf, j_init_lstm_state(jcfg.model, (1,)))
    model, _, _ = load_eval_bundle(
        parse_args([*ARGS, f"train.checkpoint_dir={tmp_path / 'port'}"])[0], device="cpu")
    with torch.no_grad():
        bpd, _ = model.nll_step(torch.from_numpy(hf), torch.from_numpy(lf),
                                init_lstm_state(cfg.model, 1, "cpu"))
    np.testing.assert_allclose(bpd.numpy(), np.asarray(want), rtol=NLL_TOL, atol=NLL_TOL)


def _drop_one(sd):
    sd.pop(sorted(sd)[0])
    return "missing parameter: "


def _misshape(sd):
    k = next(k for k in sorted(sd) if k.endswith("conv_in_0.weight"))
    sd[k] = sd[k][:, :-1]
    return f"shape mismatch {k}: "


def _add_unexpected(sd):
    sd["glow.scale9_step9.coupling.net.joint_7.weight"] = torch.zeros(1)
    return "unexpected: glow.scale9_step9"


def _drop_buffers(sd):
    for k in [k for k in sd if k.endswith((".p", ".sign_s"))]:
        del sd[k]
    return "missing buffer: "


@pytest.mark.parametrize("fault", [_drop_one, _misshape, _add_unexpected, _drop_buffers],
                         ids=["missing", "shape", "unexpected", "no_buffers"])
def test_converter_refuses_a_dump_that_does_not_fit(tmp_path, capsys, fault):
    sd = _source_state_dict()
    what = fault(sd)
    with pytest.raises(SystemExit) as e:
        _convert(tmp_path, sd)
    assert e.value.code == 1
    assert what in capsys.readouterr().out
    assert not (tmp_path / "port").exists()
    _, problems = convert_torch.validate(convert_torch.convert_state_dict(sd),
                                         TMGlow(parse_args(ARGS)[0].model, device="cpu"))
    assert problems and all(p.startswith(what.split()[0].rstrip(":")) for p in problems)


def test_norm_from_the_blob_else_the_dataset(tmp_path):
    sd = _source_state_dict()
    shipped = {k: np.full(3, v, np.float32) for k, v in zip(convert_torch.NORM_KEYS,
                                                             (0.5, 2.0, -0.25, 4.0))}
    got = _convert(tmp_path, {"state_dict": sd, "norm": shipped}, name="blob")
    for k, v in shipped.items():
        np.testing.assert_array_equal(got["norm"][k].numpy(), v)
    flat = _convert(tmp_path, {**sd, "norm": shipped}, name="flat")  # norm beside the tensors
    for k, v in shipped.items():
        np.testing.assert_array_equal(flat["norm"][k].numpy(), v)
    cfg, _ = parse_args(ARGS)
    ds_norm = load_dataset(cfg.data, cfg.model, "train").norm.to_dict()
    plain = _convert(tmp_path, sd, name="plain")
    for k, v in ds_norm.items():
        np.testing.assert_array_equal(plain["norm"][k].numpy(), v)
    for k in sd:
        assert torch.equal(got["model"][k], sd[k]) and torch.equal(plain["model"][k], sd[k]), k


def test_key_map_and_layout_rule():
    t = torch.arange(24.0).reshape(2, 3, 2, 2)
    out = convert_torch.torch_tensor_to_port("net.joint_0.weight", t.double())
    assert out.dtype == torch.float32 and torch.equal(out, t) and out.data_ptr() != t.data_ptr()
    assert convert_torch.default_key_map("glow.scale0_step1.actnorm.bias") == (
        "glow.scale0_step1.actnorm.bias")

    def key_map(key):
        if key.endswith("num_batches_tracked"):
            return None
        return re.sub(r"^module\.", "", key)

    got = convert_torch.convert_state_dict(
        {"module.a.weight": np.ones((2, 2, 3, 3)), "module.bn.num_batches_tracked": torch.ones(())},
        key_map)
    assert list(got) == ["a.weight"] and got["a.weight"].dtype == torch.float32


def test_converted_checkpoint_resumes_training(tmp_path, capsys):
    _convert(tmp_path, _source_state_dict())
    final = train_main([*ARGS, f"train.checkpoint_dir={tmp_path / 'port'}", "train.epochs=1",
                        "--device", "cpu"])
    assert "resumed from epoch 0 (step 0)" in capsys.readouterr().out
    assert final["epoch"] == 1 and np.isfinite(final["mean_bpd"])
    assert Checkpointer(tmp_path / "port" / "backward-step").steps() == [0, 1]
