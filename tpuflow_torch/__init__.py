"""tpuflow_torch: the PyTorch and CUDA port of tpuflow's TM-Glow.

The JAX package ``tpuflow`` is the reference; this package imports
nothing of it. Flow tensors are NHWC at every public function. Entry
points run on the GPU (``device="cuda"``) unless the caller names the
CPU. Ported so far: the ensemble rollout (``eval.make_ensemble_rollout``)
and NLL training (``train.Trainer``, ``cli.train``), both through the
fused affine coupling as a hand-written CUDA kernel
(``kernels.coupling_fused``), and the coupling apply + logdet entry point
as a second one (``kernels.coupling_apply``).
"""
