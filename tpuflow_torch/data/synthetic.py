"""Procedural multi-fidelity flow fixtures for both benchmark cases.

The port's own copy of ``tpuflow/data/synthetic.py`` (NumPy only): for
the same seed and arguments, :func:`generate_case` returns arrays
identical to the JAX package's. HF (N, T, H, W, 3) and LF
(N, T, h, w, 3) come from an analytic vortex-street model:

* v1: the LF field is an average-pooled, diffused, amplitude-biased
  rendering of the HF field (spatial and static bias only).
* v2: the LF trajectory is a separate coarse re-run of the same flow
  with an advection-speed deficit and a shedding-frequency drift (LF
  phase error grows over the trajectory), plus a sharp spectral
  truncation of the high wavenumbers.
* v3 (the default of ``DataConfig``): v2 plus a broadband HF-only
  turbulent cascade (E(k) ~ k^-3 between the LF and HF resolution
  limits), drawn after every v2 draw so that v1 and v2 streams are
  unchanged.

All generation is vectorized NumPy on the host.
"""

from __future__ import annotations

import numpy as np

_CASES = ("backward-step", "cylinder-array")


def _vortex_uv(x, y, cx, cy, strength, radius):
    """Gaussian-core vortex velocity at grid (x, y) for centers along
    leading axes. Shapes broadcast: x,y are (H, W); cx,cy,strength are
    (..., 1, 1)."""
    dx = x - cx
    dy = y - cy
    r2 = dx * dx + dy * dy
    core = strength * np.exp(-r2 / (2.0 * radius * radius))
    return -dy * core, dx * core


def _case_params(case: str, rng: np.random.Generator):
    """Per-trajectory physical parameters (the 'varying Reynolds
    number / geometry' axis of the reference datasets)."""
    if case == "backward-step":
        return {
            "re": rng.uniform(0.8, 1.6),           # advection-speed scale
            "strength": rng.uniform(0.6, 1.2),
            "shed_freq": rng.uniform(0.8, 1.4),
            "n_vortices": 6,
        }
    if case == "cylinder-array":
        return {
            "re": rng.uniform(0.8, 1.6),
            "strength": rng.uniform(0.5, 1.0),
            "shed_freq": rng.uniform(1.0, 1.8),
            "n_rows": 3,
            "n_vortices": 4,
        }
    raise ValueError(f"unknown case {case!r}; known: {_CASES}")


def _vortex_phases(case, params, rng):
    """Draw the per-vortex shedding phases once, so an HF run and its
    v2 LF re-run share vortex identities. Order matches the original
    in-loop draws exactly (v1 bit-compatibility)."""
    n_origins = params.get("n_rows", 1) if case == "cylinder-array" else 1
    spacing = 0.9 / params["shed_freq"]
    return [
        [rng.uniform(0.0, spacing) for _ in range(params["n_vortices"])]
        for _ in range(n_origins)
    ]


def _hf_trajectory(case, params, steps, hf_shape, phases,
                   adv_scale=1.0, freq_scale=1.0):
    h, w = hf_shape
    # Domain: x in [0, 4), y in [0, 1).
    ys, xs = np.meshgrid(
        np.linspace(0.0, 1.0, h, endpoint=False),
        np.linspace(0.0, 4.0, w, endpoint=False),
        indexing="ij",
    )
    t = np.arange(steps, dtype=np.float64)[:, None, None] * 0.05
    u = np.zeros((steps, h, w))
    v = np.zeros((steps, h, w))

    adv = params["re"] * adv_scale
    freq = params["shed_freq"] * freq_scale
    if case == "backward-step":
        # Mean shear: parabolic channel profile downstream of the step.
        step_x, step_y = 0.5, 0.5
        u += adv * 4.0 * ys * (1.0 - ys)
        origins = [(step_x, step_y)]
    else:
        # Uniform inflow past rows of cylinders.
        u += adv * 0.8
        rows = params["n_rows"]
        origins = [(0.6, (r + 0.5) / rows) for r in range(rows)]

    spacing = 0.9 / params["shed_freq"]
    for (ox, oy), origin_phases in zip(origins, phases):
        for k in range(params["n_vortices"]):
            sign = 1.0 if k % 2 == 0 else -1.0
            phase = origin_phases[k]
            # Vortices advect downstream and wrap (statistically
            # stationary wake, like the reference's developed flows).
            # adv/freq carry the coarse-run scale factors: a v2 LF
            # re-run accumulates phase error linearly in t.
            cx = ox + ((adv * t + k * spacing + phase) % (4.0 - ox))
            cy = oy + sign * 0.08 * np.sin(
                2.0 * np.pi * freq * t + k
            )
            du, dv = _vortex_uv(
                xs, ys, cx, cy, sign * params["strength"], 0.28
            )
            u += du
            v += dv

    # Bernoulli-flavoured pressure: p = -1/2 |u|^2, fluctuation part.
    p = -0.5 * (u * u + v * v)
    p -= p.mean(axis=(1, 2), keepdims=True)
    hf = np.stack([u, v, p], axis=-1).astype(np.float32)

    if case == "backward-step":
        # Solid step region: zero velocity (geometry mask).
        hf[:, _bstep_mask(hf_shape), :2] = 0.0
    return hf


def _bstep_mask(hf_shape: tuple[int, int]) -> np.ndarray:
    """Backward-step solid-region mask (shared by _hf_trajectory and
    the v3 cascade injection so the geometry cannot drift)."""
    h, w = hf_shape
    ys, xs = np.meshgrid(
        np.linspace(0.0, 1.0, h, endpoint=False),
        np.linspace(0.0, 4.0, w, endpoint=False),
        indexing="ij",
    )
    return (xs < 0.5) & (ys < 0.5)


def _degrade_to_lf(hf, lf_shape, rng, spectral_cut=0.0):
    """HF -> LF: average-pool to the coarse grid, diffuse, optionally
    truncate high wavenumbers (v2: coarse-mesh resolution limit), add a
    small smooth bias field (the coarse-solver 'model error')."""
    t, h, w, c = hf.shape
    lh, lw = lf_shape
    fh, fw = h // lh, w // lw
    lf = hf.reshape(t, lh, fh, lw, fw, c).mean(axis=(2, 4))
    # One Jacobi-diffusion sweep (numerical dissipation of the coarse solver).
    pad = np.pad(lf, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
    lf = 0.5 * lf + 0.125 * (
        pad[:, :-2, 1:-1] + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2] + pad[:, 1:-1, 2:]
    )
    # Smooth static bias per trajectory.
    bias = rng.normal(0.0, 0.05, size=(1, lh, lw, c)).astype(np.float32)
    for _ in range(4):
        bp = np.pad(bias, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="edge")
        bias = 0.25 * (bp[:, :-2, 1:-1] + bp[:, 2:, 1:-1] + bp[:, 1:-1, :-2] + bp[:, 1:-1, 2:])
    lf = lf + bias
    if spectral_cut > 0.0:
        # Sharp isotropic low-pass at spectral_cut * Nyquist, applied
        # to the WHOLE coarse field (solution + model-error bias): a
        # coarse mesh cannot represent the top modes at all, so they
        # are REMOVED, not just damped (v1's diffusion only damps).
        # Per-axis normalization keeps the 4:1 domains isotropic in
        # index space.
        ky = np.fft.fftfreq(lh)[:, None] / 0.5
        kx = np.fft.rfftfreq(lw)[None, :] / 0.5
        mask = (ky * ky + kx * kx) <= spectral_cut * spectral_cut
        spec = np.fft.rfft2(lf, axes=(1, 2))
        lf = np.fft.irfft2(spec * mask[None, :, :, None], s=(lh, lw), axes=(1, 2))
    return lf.astype(np.float32)


def _cascade_fluct(
    steps: int,
    hf_shape: tuple[int, int],
    lf_shape: tuple[int, int],
    rng: np.random.Generator,
    adv: float,
    dt: float = 0.05,
    slope: float = -3.0,
    tau0: float = 0.45,
) -> tuple[np.ndarray, np.ndarray]:
    """Divergence-free broadband velocity fluctuations (fixture v3).

    Spectral streamfunction psi with |psi_k| ~ k^((slope-3)/2) so the
    radial kinetic-energy spectrum follows E(k) ~ k^slope (2D
    enstrophy-range default -3), restricted to the band between the LF
    grid's isotropic Nyquist (what a coarse mesh can carry) and the HF
    grid's. Each Fourier mode advects downstream at the mean speed and
    decorrelates as AR(1) with time constant tau0 * (k_lo / k): small
    eddies forget fastest, so the fine-scale realization is
    unpredictable beyond ~one eddy turnover — the physical reason an
    ensemble surrogate beats any deterministic interpolant at high k.

    Returns (u', v') of shape (steps, H, W), unit total RMS (caller
    scales).
    """
    h, w = hf_shape
    ly, lx = 1.0, 4.0  # fixed fixture domain (see _hf_trajectory)
    ky = np.fft.fftfreq(h)[:, None] * h / ly   # cycles per unit length
    kx = np.fft.rfftfreq(w)[None, :] * w / lx
    kr = np.sqrt(ky * ky + kx * kx)
    k_hi = min(h / (2 * ly), w / (2 * lx))
    k_lo = 0.8 * min(lf_shape[0] / (2 * ly), lf_shape[1] / (2 * lx))
    band = (kr >= k_lo) & (kr <= k_hi)
    with np.errstate(divide="ignore"):
        amp = np.where(band, kr ** ((slope - 3.0) / 2.0), 0.0)
    amp[~np.isfinite(amp)] = 0.0

    def innovation() -> np.ndarray:
        # rfft2 of a real white field is Hermitian-consistent by
        # construction (no manual symmetry bookkeeping).
        return np.fft.rfft2(rng.standard_normal((h, w))) * amp

    rho = np.exp(-dt * np.maximum(kr, k_lo) / (tau0 * k_lo))
    phase = np.exp(-2j * np.pi * kx * adv * dt)
    psi = innovation()
    u = np.empty((steps, h, w), np.float64)
    v = np.empty((steps, h, w), np.float64)
    for t in range(steps):
        if t > 0:
            psi = phase * rho * psi + np.sqrt(1.0 - rho * rho) * innovation()
        # u = d(psi)/dy, v = -d(psi)/dx: solenoidal by construction.
        u[t] = np.fft.irfft2(2j * np.pi * ky * psi, s=(h, w))
        v[t] = np.fft.irfft2(-2j * np.pi * kx * psi, s=(h, w))
    rms = np.sqrt(np.mean(u * u + v * v)) + 1e-12
    return (u / rms).astype(np.float32), (v / rms).astype(np.float32)


def generate_case(
    case: str,
    n_traj: int,
    steps: int,
    hf_shape: tuple[int, int],
    lf_shape: tuple[int, int],
    seed: int = 0,
    fixture_version: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate aligned (LF, HF) trajectory arrays for a benchmark case.

    fixture_version: 1 = spatial degradation only (golden-pinned, bit
    stable); 2 = LF is a coarse re-run with growing temporal phase
    error + spectral truncation (see module docstring). v1 draws are a
    prefix of v2's random stream, so v1 arrays are identical whichever
    version existed when a seed was pinned.

    Returns:
      lf: (n_traj, steps, lh, lw, 3) float32
      hf: (n_traj, steps, H, W, 3) float32
    """
    if case not in _CASES:
        raise ValueError(f"unknown case {case!r}; known: {_CASES}")
    if fixture_version not in (1, 2, 3):
        raise ValueError(
            f"fixture_version must be 1, 2 or 3, got {fixture_version}"
        )
    root = np.random.default_rng(seed)
    lf_all, hf_all = [], []
    for n in range(n_traj):
        rng = np.random.default_rng(root.integers(0, 2**63 - 1))
        params = _case_params(case, rng)
        phases = _vortex_phases(case, params, rng)
        hf = _hf_trajectory(case, params, steps, hf_shape, phases)
        if fixture_version == 1:
            lf = _degrade_to_lf(hf, lf_shape, rng)
        else:
            # The LF trajectory is a separate coarse-solver run: same
            # vortices/phases, but the solver under-predicts advection
            # speed and drifts in shedding frequency — phase error
            # grows linearly over the trajectory — and its mesh cannot
            # carry the top wavenumbers (sharp spectral truncation).
            adv_scale = rng.uniform(0.82, 0.92)
            freq_scale = rng.uniform(0.90, 0.98)
            lf_src = _hf_trajectory(
                case, params, steps, hf_shape, phases,
                adv_scale=adv_scale, freq_scale=freq_scale,
            )
            lf = _degrade_to_lf(lf_src, lf_shape, rng, spectral_cut=0.6)
        if fixture_version == 3:
            # Broadband HF-only cascade (module docstring, v3): drawn
            # AFTER every v2 draw so v1/v2 streams stay bit-stable;
            # never enters the LF pipeline (the coarse mesh cannot
            # carry the band, and the realization is unpredictable
            # from LF by construction).
            cu, cv = _cascade_fluct(
                steps, hf_shape, lf_shape, rng, adv=0.8 * params["re"]
            )
            fluct = hf[..., :2] - hf[..., :2].mean(axis=0, keepdims=True)
            a = 0.30 * float(np.sqrt((fluct ** 2).mean()))
            u = hf[..., 0] + a * cu
            v = hf[..., 1] + a * cv
            p = -0.5 * (u * u + v * v)
            p -= p.mean(axis=(1, 2), keepdims=True)
            hf = np.stack([u, v, p], axis=-1).astype(np.float32)
            if case == "backward-step":
                hf[:, _bstep_mask(hf_shape), :2] = 0.0
        hf_all.append(hf)
        lf_all.append(lf)
    return np.stack(lf_all), np.stack(hf_all)
