"""The first windows of full-width training, the PyTorch port against the
JAX package, on the CPU.

    python tools/train_gap.py [--windows 3] [--batch 2]

Both sides start from the same weights: the JAX model's ``model.init`` on
the first frame of the batch (ActNorm's data-dependent init, as the JAX
trainer's fresh init does), carried to the port by
``tpuflow_torch.convert.from_flax``. The model is the backward-step
preset at full width with float32 nets; the data is the preset's
procedural fixture (v3), ``--batch`` trajectories of ``--windows`` x 8
steps; the optimizer is the preset's (Adam, lr 5e-4, continuous decay
0.995 per 100 steps, global-norm clip 100). Then ``--windows`` BPTT
windows of 8 steps, the state carried with its gradient cut:

  * "port": ``tpuflow_torch.train.trajectory_train_step`` (each window's
    bits/dim and gradient norm before the clip);
  * "jax": ``tpuflow.train.step.make_trajectory_train_step`` (each
    window's bits/dim, the mean gradient norm), and, for each window's
    gradient norm, ``make_train_step`` window by window, the same update
    sequence;
  * the rounding floor: the first window's bits/dim (the same weights,
    no update yet) from JAX's default XLA path and from its fused
    coupling numerics (``xla_reference``, as ``tools/bf16_gap.py`` routes
    it), two float32 programs of the same function that differ only in
    the couplings' summation order;
  * the log-determinant at the init, per example of the first frame:
    JAX's, the port's, and the exact value in float64 from the
    parameters. At the init every coupling's head is zero, so its scale
    is sigmoid(2) everywhere and the whole log-determinant is a function
    of the parameters alone: the sum over scales l and steps k of
    H_l W_l (sum(actnorm log_scale) + sum(inv-1x1 log_s) + c_l
    log sigmoid(2)), c_l the coupling's half width.

It prints one JSON line: both sides' per-window bits/dim and gradient
norms, their largest relative gaps, the floor and the log-determinants.
Like ``export_to_torch.py`` it imports both packages and runs where JAX
is; nothing in ``tpuflow_torch`` imports it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASE = "backward-step"
WINDOW = 8


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=3, help="BPTT windows (default 3)")
    ap.add_argument("--batch", type=int, default=2, help="trajectories (default 2)")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from tpuflow.configs.config import load_case as j_load_case
    from tpuflow.data.dataset import load_dataset as j_load_dataset
    from tpuflow.eval.rollout import make_nll_eval as j_make_nll_eval
    from tpuflow.models import TMGlow as JTMGlow
    from tpuflow.models import init_lstm_state as j_init_lstm_state
    from tpuflow.train.step import make_optimizer as j_make_optimizer
    from tpuflow.train.step import make_train_step as j_make_train_step
    from tpuflow.train.step import make_trajectory_train_step as j_make_trajectory_train_step
    from tpuflow_torch.configs import load_case
    from tpuflow_torch.convert import from_flax
    from tpuflow_torch.models import TMGlow, init_lstm_state, latent_shapes, scale_shapes
    from tpuflow_torch.train import make_optimizer, trajectory_train_step

    b, steps = args.batch, args.windows * WINDOW
    over = {"model.compute_dtype": "float32", "data.n_train_traj": b,
            "data.train_steps": steps, "data.batch_size": b}
    jcfg = j_load_case(CASE, over)
    cfg = load_case(CASE, over)
    ds = j_load_dataset(jcfg.data, jcfg.model, "train")
    lf, hf = next(ds.traj_batches(jcfg.data.seed, b))
    tr = jcfg.train

    t0 = time.perf_counter()
    jm = JTMGlow(jcfg.model)
    variables = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(tr.seed), jnp.asarray(hf[:, 0]), jnp.asarray(lf[:, 0]),
        j_init_lstm_state(jcfg.model, (b,))))
    params, buffers = variables["params"], variables["buffers"]
    tx = j_make_optimizer(tr.lr, tr.lr_decay, tr.grad_clip, tr.weight_decay)
    traj = jax.jit(j_make_trajectory_train_step(jm, tx, WINDOW))
    _, _, m_traj = traj(params, buffers, tx.init(params), jnp.asarray(lf), jnp.asarray(hf))
    step = jax.jit(j_make_train_step(jm, tx))
    p, st, state = params, tx.init(params), j_init_lstm_state(jcfg.model, (b,))
    jax_bpd, jax_gnorm = [], []
    for w in range(args.windows):
        sl = slice(w * WINDOW, (w + 1) * WINDOW)
        p, st, state, m = step(p, buffers, st, jnp.asarray(lf[:, sl]), jnp.asarray(hf[:, sl]),
                               state)
        jax_bpd.append(float(m["bpd"]))
        jax_gnorm.append(float(m["grad_norm"]))
    sys.path.insert(0, str(ROOT / "tools"))
    from bf16_gap import jax_fused_path

    jm_fused = JTMGlow(j_load_case(CASE, {**over, "model.use_pallas": True}).model)
    with jax_fused_path():
        fused_first = float(jax.jit(j_make_nll_eval(jm_fused))(
            variables, jnp.asarray(lf[:, :WINDOW]), jnp.asarray(hf[:, :WINDOW])).mean())
    _, ld_jax, _, _ = jax.jit(lambda *a: jm.apply(*a, method=JTMGlow.encode_step))(
        variables, jnp.asarray(hf[:, 0]), jnp.asarray(lf[:, 0]), j_init_lstm_state(jcfg.model, (b,)))
    jax_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = TMGlow(cfg.model, device="cpu", seed=tr.seed)
    model.load_state_dict(from_flax(variables, model))
    with torch.no_grad():
        _, ld_port, _, _ = model.encode_step(torch.from_numpy(hf[:, 0]), torch.from_numpy(lf[:, 0]),
                                             init_lstm_state(cfg.model, b, "cpu"))
    sd = {k: v.double().numpy() for k, v in model.state_dict().items()}
    log_sig2 = -np.log1p(np.exp(-2.0))
    ld_exact = 0.0
    for l, ((h, w), lat) in enumerate(zip(scale_shapes(cfg.model), latent_shapes(cfg.model, 1))):
        ca = (lat[-1] * (2 if l < cfg.model.n_scales - 1 else 1)) // 2
        for k in range(cfg.model.n_flow_steps):
            pre = f"glow.scale{l}_step{k}"
            ld_exact += h * w * (sd[f"{pre}.actnorm.log_scale"].sum()
                                 + sd[f"{pre}.invconv.log_s"].sum() + ca * log_sig2)
    opt, sched = make_optimizer(model.parameters(), tr.lr, tr.lr_decay, tr.weight_decay)
    m_port = trajectory_train_step(model, opt, sched, tr.grad_clip, WINDOW, torch.from_numpy(lf),
                                   torch.from_numpy(hf))
    port_s = time.perf_counter() - t0

    traj_bpd = [float(v) for v in np.asarray(m_traj["bpd_per_window"])]
    port_bpd = m_port["bpd"].tolist()
    port_gnorm = m_port["grad_norm"].tolist()

    def gap(a, b):
        return max(abs(x - y) / max(1.0, abs(y)) for x, y in zip(a, b))

    out = {
        "windows": args.windows, "batch": b, "window": WINDOW, "dtype": "float32",
        "lr": tr.lr, "grad_clip": tr.grad_clip,
        "port": {"bpd": port_bpd, "grad_norm": port_gnorm, "seconds": round(port_s, 1)},
        "jax": {"bpd": traj_bpd, "grad_norm": jax_gnorm,
                "grad_norm_mean": float(m_traj["grad_norm"]),
                "bpd_window_by_window": jax_bpd, "seconds": round(jax_s, 1)},
        "bpd_rel_gap": gap(port_bpd, traj_bpd),
        "grad_norm_rel_gap": gap(port_gnorm, jax_gnorm),
        "jax_paths_bpd_rel_gap": gap(jax_bpd, traj_bpd),
        "floor": {"jax_fused_first_window_bpd": fused_first,
                  "jax_fused_vs_default": abs(fused_first - traj_bpd[0]),
                  "port_vs_jax_default": abs(port_bpd[0] - traj_bpd[0]),
                  "port_vs_jax_fused": abs(port_bpd[0] - fused_first)},
        "logdet_at_init": {"port": ld_port.tolist(), "jax": np.asarray(ld_jax).tolist(),
                           "exact_float64": ld_exact},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    main()
