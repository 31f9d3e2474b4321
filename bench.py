"""Benchmark driver: batched 1-D fp32 FFT throughput + accuracy vs fp64 oracle.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}.

Primary metric: GFLOP/s (5·N·log2 N flop model, matching BASELINE.md) of the
batched N=1024 complex fp32 transform on the GPU.  vs_baseline is the ratio
to the reference C library's best sustained single-core throughput,
8.5 GFLOP/s (BASELINE.md — measured at N=512; the reference's own N=1024
output is incorrect, SURVEY.md §2.9, so its throughput there is a cost
indicator only).

One process on one GPU runs the configs in turn; without a GPU, or for a
device kind missing from :data:`PEAKS`, it exits non-zero before timing
anything.  Timing rides device-chained iterations (lax.fori_loop):
per-transform time is the **marginal** cost between a short and a long
chained run (two-point linear fit), so fixed dispatch overhead cancels.

    python bench.py [--detail PATH]    # one JSON line; full records to PATH
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from mixed_radix_fast_fourier_transform_tpu.ops.stockham import exec_complex
from mixed_radix_fast_fourier_transform_tpu.plan import get_plan

REFERENCE_GFLOPS = 8.5  # BASELINE.md: reference C, N=512, 1-core Xeon 2.7 GHz

# Published peaks per device_kind (as jax.devices()[0].device_kind reports
# it), dense rates without sparsity, rated at the card's full power limit.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5 and PCIe columns).
# A card capped below that limit reports the same device_kind but cannot
# reach these rates, so a pct_fp32_peak reading holds only beside the power
# limit printed with it (nvidia-smi power.limit).
# The engine's stage matmuls run at precision=HIGHEST, i.e. fp32 outside the
# tensor cores, so fp32_gflops is the peak its flops are divided by.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # H100 SXM5, 700 W
        "fp32_gflops": 67_000.0, "tf32_gflops": 494_700.0,
        "bf16_gflops": 989_400.0, "hbm_gbps": 3_350.0, "hbm_gb": 80.0,
    },
    "NVIDIA H100 PCIe": {  # H100 PCIe, 350 W
        "fp32_gflops": 51_200.0, "tf32_gflops": 378_000.0,
        "bf16_gflops": 756_000.0, "hbm_gbps": 2_000.0, "hbm_gb": 80.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The :data:`PEAKS` row of ``device_kind``; a device missing from the
    table is an error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add a "
            f"row with its source to bench.PEAKS"
        ) from None


def _flops(n: int, batch: int) -> float:
    return 5.0 * n * math.log2(n) * batch


def bench_config(n: int, batch: int, iters: int, seed: int = 0):
    """Return (gflops, max_rel_err) for a batched length-n complex fp32 FFT.

    ``iters`` is the short chain length; the long chain is 5x.  Per-transform
    time = (T_long - T_short) / (4*iters) via profiling.marginal_time — the
    dispatch/fetch overhead cancels, and completion is forced through a
    scalar fetch.  ``pct_fp32_peak`` divides by the device's :data:`PEAKS`
    row.
    """
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    plan = get_plan(n, -1, "complex")
    xr = jax.device_put(x.real.astype(np.float32))
    xi = jax.device_put(x.imag.astype(np.float32))

    fn = lambda ar, ai: exec_complex(plan, ar, ai)

    # accuracy (single application, fp64 numpy oracle)
    zr, zi = jax.jit(fn)(xr, xi)
    got = np.asarray(zr).astype(np.complex128) + 1j * np.asarray(zi)
    want = np.fft.fft(x, axis=-1)
    err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))

    # median of three marginal measurements: clock state drifts over
    # minutes, corrupting single short-vs-long diffs in either direction
    ts = sorted(
        marginal_time(fn, (xr, xi), short=iters, long=5 * iters)
        for _ in range(3)
    )
    dt = ts[1]

    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        roofline_summary,
    )

    fp32_peak_gflops = device_peaks(
        jax.devices()[0].device_kind)["fp32_gflops"]
    roof = roofline_summary(plan, dt, batch)
    return {
        "gflops": round(roof["gflops_fft_model"], 2),
        "max_rel_err": float(f"{err:.3g}"),
        "gflops_actual": round(roof["gflops_actual"], 2),
        "arithmetic_intensity": round(roof["arithmetic_intensity"], 2),
        # engine flops (stage matmuls + twiddles) over the fp32 peak
        "pct_fp32_peak": round(
            100.0 * roof["gflops_actual"] / fp32_peak_gflops, 2
        ),
    }, err


def bench_vs_xla_builtin(n: int, batch: int, iters: int, seed: int = 0) -> float:
    """Interleaved A/B ratio of XLA's builtin jnp.fft.fft time over this
    library's pipeline (>1 means this library is faster).  Interleaving is
    required: the chip's effective speed drifts between sequentially-timed
    configs, so two separately-measured GFLOP/s numbers are not comparable."""
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import ab_compare

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    xr = jax.device_put(x.real.astype(np.float32))
    xi = jax.device_put(x.imag.astype(np.float32))
    plan = get_plan(n, -1, "complex")

    def builtin(ar, ai):
        z = jnp.fft.fft(jax.lax.complex(ar, ai))
        return jnp.real(z), jnp.imag(z)

    ours = lambda ar, ai: exec_complex(plan, ar, ai)
    res = ab_compare(builtin, ours, (xr, xi), short=iters, long=5 * iters,
                     rounds=5)
    return res["ratio_median"]


def bench_rfft_vs_builtin(n: int, batch: int, iters: int, seed: int = 0) -> float:
    """Interleaved A/B ratio of the builtin rfft→irfft round trip over this
    library's (>1 means this library is faster)."""
    from mixed_radix_fast_fourier_transform_tpu.ops.rfft import irfft, rfft
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import ab_compare

    rng = np.random.default_rng(seed)
    x = jax.device_put(rng.standard_normal((batch, n)).astype(np.float32))
    ours = lambda a: (irfft(rfft(a), n=n),)
    builtin = lambda a: (jnp.fft.irfft(jnp.fft.rfft(a), n=n),)
    res = ab_compare(builtin, ours, (x,), short=iters, long=5 * iters, rounds=5)
    return res["ratio_median"]


def bench_rfft_roundtrip(n: int, batch: int, iters: int, seed: int = 0):
    """(gflops, max_abs_roundtrip_err) for rfft→irfft of real fp32 signals
    (BASELINE config 3).  Flop model: two half-transforms = 5·N·log2 N."""
    from mixed_radix_fast_fourier_transform_tpu.ops.rfft import irfft, rfft
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    xd = jax.device_put(x)

    def fn(a):
        return (irfft(rfft(a), n=n),)

    back = np.asarray(jax.jit(fn)(xd)[0])
    # relative error so it folds into the 1e-5 budget check
    err = float(np.max(np.abs(back - x)) / np.max(np.abs(x)))
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return _flops(n, batch) / dt / 1e9, err


def bench_convolve(n_sig: int, n_ker: int, batch: int, iters: int, seed: int = 0):
    """(gflops, max_abs_err vs numpy) for batched 'same' FFT convolution
    (BASELINE config 5's single-chip shape).  Flop model: 3 rFFT-class
    transforms of the padded length."""
    from mixed_radix_fast_fourier_transform_tpu.ops.convolve import (
        _padded_len,
        fft_convolve,
    )
    from mixed_radix_fast_fourier_transform_tpu.utils.config import DEFAULT_CONFIG
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n_sig)).astype(np.float32)
    k = rng.standard_normal(n_ker).astype(np.float32)
    xd, kd = jax.device_put(x), jax.device_put(k[None, :])

    def fn(a):
        out = fft_convolve(a, kd, mode="same")
        return (out,)

    got = np.asarray(jax.jit(fn)(xd)[0])
    want = np.stack([np.convolve(r.astype(np.float64), k, mode="same") for r in x[:4]])
    # relative error so it folds into the 1e-5 budget check
    err = float(np.max(np.abs(got[:4] - want)) / np.max(np.abs(want)))
    m = _padded_len(n_sig + n_ker - 1, DEFAULT_CONFIG)
    fl = 3 * 2.5 * m * math.log2(m) * batch
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return fl / dt / 1e9, err


def bench_nufft(n: int, m: int, iters: int, seed: int = 0):
    """(seconds-per-transform, rel err vs the dense NUDFT oracle) for the
    1-D type-1 NUFFT grid path at ``n`` modes / ``m`` points (the
    block-matmul spreading path — no scatter)."""
    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = jax.device_put(rng.uniform(0, 2 * math.pi, m).astype(np.float32))
    cr = jax.device_put(rng.standard_normal(m).astype(np.float32))
    ci = jax.device_put(rng.standard_normal(m).astype(np.float32))

    def run(method):
        def fn(ar, ai):
            out = nf.nufft1(x, jax.lax.complex(ar, ai), n, method=method)
            return jnp.real(out)[..., :m], jnp.imag(out)[..., :m]
        return fn

    zr, zi = jax.jit(run("grid"))(cr, ci)
    wr, wi = jax.jit(run("dense"))(cr, ci)
    g = np.asarray(zr) + 1j * np.asarray(zi)
    w = np.asarray(wr) + 1j * np.asarray(wi)
    err = float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
    dt = marginal_time(run("grid"), (cr, ci), short=iters, long=5 * iters)
    return dt, err


def bench_sht(L: int, batch: int, iters: int, seed: int = 0):
    """(seconds per analysis+synthesis round trip, projection error) at band
    limit L (triangular-chunked Legendre path)."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    f0 = jax.device_put(rng.standard_normal((batch, L, 2 * L)).astype(np.float32))

    def rt(g):
        # real-field Hermitian fast paths both ways (measured 2.52x at L=256)
        return (sp.isht(sp.sht(g), real_output=True).astype(jnp.float32),)

    # idempotence of the band-limit projection: a second round trip must
    # reproduce the first to the engine's fp32 floor
    f1 = np.asarray(jax.jit(rt)(f0)[0])
    f2 = np.asarray(jax.jit(rt)(jnp.asarray(f1))[0])
    err = float(np.max(np.abs(f2 - f1)) / max(1e-9, np.max(np.abs(f1))))
    dt = marginal_time(rt, (f0,), short=iters, long=5 * iters)
    return dt, err


def bench_rader_vs_bluestein(n: int, batch: int, iters: int, seed: int = 0):
    """Interleaved A/B: Bluestein time over Rader time for a prime ``n``
    with smooth n−1 (>1 means Rader is faster).  Measures the round-4
    prime-path flop cut (two (n−1)-point inner FFTs vs two ~2.4n ones)."""
    from mixed_radix_fast_fourier_transform_tpu.utils.config import SpectralConfig
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import ab_compare

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    xr = jax.device_put(x.real.astype(np.float32))
    xi = jax.device_put(x.imag.astype(np.float32))
    rader = get_plan(n, -1, "complex", SpectralConfig(rader="auto"))
    blue = get_plan(n, -1, "complex", SpectralConfig(rader="off"))
    fn_r = lambda ar, ai: exec_complex(rader, ar, ai)
    fn_b = lambda ar, ai: exec_complex(blue, ar, ai)
    res = ab_compare(fn_b, fn_r, (xr, xi), short=iters, long=5 * iters,
                     rounds=5)
    return res["ratio_median"]


def bench_nufft2(n: int, m: int, iters: int, seed: int = 0):
    """(seconds-per-transform, rel err vs dense) for 1-D type-2 NUFFT
    interpolation — the round-3 tap-matmul path (was gather-bound)."""
    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = jax.device_put(rng.uniform(0, 2 * math.pi, m).astype(np.float32))
    fr = jax.device_put(rng.standard_normal(n).astype(np.float32))
    fi = jax.device_put(rng.standard_normal(n).astype(np.float32))

    def run(method):
        def fn(ar, ai):
            out = nf.nufft2(x, jax.lax.complex(ar, ai), method=method)
            return jnp.real(out), jnp.imag(out)
        return fn

    g = jax.jit(run("grid"))(fr, fi)
    w = jax.jit(run("dense"))(fr, fi)
    g = np.asarray(g[0]) + 1j * np.asarray(g[1])
    w = np.asarray(w[0]) + 1j * np.asarray(w[1])
    err = float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
    dt = marginal_time(run("grid"), (fr, fi), short=iters, long=5 * iters)
    return dt, err


def bench_nufft3_2d(m: int, k: int, iters: int, seed: int = 0,
                    s_extent: float | None = None, method: str = "auto"):
    """(seconds-per-transform, rel err vs dense at 512²) for the 2-D type-3
    NUFFT.

    With s_extent = m/4 the space-bandwidth product per axis is m·π/4 — at
    m=4096 the fast path's inner grid is ~16384², far more work than the
    dense matmul, and method='auto' (the library default dispatch) picks
    dense there.  The fast path's own regime is large M·K on a
    MODEST space-bandwidth product, benched separately with s_extent=128
    at M=K=65536 (dense there is a 4.3e9-entry matrix — infeasible)."""
    from mixed_radix_fast_fourier_transform_tpu.ops import nufft as nf
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    sext = float(s_extent) if s_extent is not None else m / 4

    def make(mm, kk, se):
        x = rng.uniform(-math.pi, math.pi, mm).astype(np.float32)
        y = rng.uniform(-math.pi, math.pi, mm).astype(np.float32)
        s = rng.uniform(-se, se, kk).astype(np.float32)
        t = rng.uniform(-se, se, kk).astype(np.float32)
        c = (rng.standard_normal(mm) + 1j * rng.standard_normal(mm))
        return (jax.device_put(x), jax.device_put(y), jax.device_put(s),
                jax.device_put(t),
                jax.device_put(c.real.astype(np.float32)),
                jax.device_put(c.imag.astype(np.float32)))

    def ext(se):
        # static per-axis half-widths — required for "fast"/"auto" under jit
        return dict(x_extent=math.pi, y_extent=math.pi,
                    s_extent=se, t_extent=se)

    # accuracy at a dense-checkable size, same S·X class when it fits; the
    # error reduces on the device to a real scalar
    acc_ext = min(sext, 128.0)
    xs, ys, ss, ts, csr, csi = make(512, 512, acc_ext)

    def acc(ar, ai):
        c = jax.lax.complex(ar, ai)
        # Always check the FAST path against the dense oracle: dense IS the
        # oracle, so letting the auto dispatch pick (it picks dense at this
        # check size) would compare the oracle to itself and gate nothing
        # (round-5 review finding).
        g = nf.nufft3_2d(xs, ys, c, ss, ts, method="fast", **ext(acc_ext))
        w = nf.nufft3_2d(xs, ys, c, ss, ts, method="dense")
        return jnp.max(jnp.abs(g - w)) / jnp.max(jnp.abs(w))

    err = float(jax.jit(acc)(csr, csi))
    # throughput at the claimed size
    x, y, s, t, cr, ci = make(m, k, sext)

    def fn(ar, ai):
        # carrier pattern: out has k entries, the chain carry has m — fold
        # the result back through a scalar so (m, k) can vary independently
        out = nf.nufft3_2d(x, y, jax.lax.complex(ar, ai), s, t,
                           method=method, **ext(sext))
        eps = jnp.asarray(1e-20, ar.dtype)
        return (ar + eps * jnp.sum(jnp.real(out)).astype(ar.dtype),
                ai + eps * jnp.sum(jnp.imag(out)).astype(ai.dtype))

    dt = marginal_time(fn, (cr, ci), short=iters, long=5 * iters)
    return dt, err


def bench_resample_poly(n: int, batch: int, iters: int, seed: int = 0):
    """(seconds-per-signal, rel err vs scipy fp64) for 3/2 polyphase
    resampling (window-gather path)."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    xd = jax.device_put(x)
    up, down = 3, 2

    def fn(a):
        # marginal_time chains same-shaped carries; fold the (3/2-length)
        # output back into the carry through a scalar (bench_cqt pattern)
        y = sp.resample_poly(a, up, down)
        return (a + jnp.asarray(1e-20, a.dtype) * jnp.sum(y).astype(a.dtype),)

    got = np.asarray(jax.jit(lambda a: sp.resample_poly(a, up, down))(xd))
    try:
        from scipy.signal import resample_poly as sp_rp

        want = sp_rp(x[:2].astype(np.float64), up, down, axis=-1)
        err = float(np.max(np.abs(got[:2] - want)) / np.max(np.abs(want)))
    except Exception:  # pragma: no cover — scipy optional at bench time
        err = float("nan")
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return dt / batch, err


def bench_multitaper(batch: int, n: int, k: int, iters: int, seed: int = 0):
    """(seconds per batched PSD, white-noise flatness err) for the Thomson
    multitaper estimator."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    xd = jax.device_put(x)

    def fn(a):
        f, p = sp.multitaper(a, nw=4.0, k=k)
        return (a + jnp.asarray(1e-20, a.dtype) * jnp.sum(p).astype(a.dtype),)

    _, psd = jax.jit(lambda a: sp.multitaper(a, nw=4.0, k=k))(xd)
    psd = np.asarray(psd)
    # unit-variance white noise → one-sided density flat at 2/fs = 2.0 away
    # from the DC/Nyquist bins; coarse correctness check, not a 1e-5 budget
    flat = float(abs(np.mean(psd[..., 1:-1]) - 2.0) / 2.0)
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return dt, flat


def bench_cqt(batch: int, n: int, iters: int, seed: int = 0):
    """(seconds per signal, peak-band correctness flag) for the 84-band
    constant-Q transform at ``n`` samples — the audio front-end headline
    (one frame FFT + one dense spectral-kernel matmul)."""
    import mixed_radix_fast_fourier_transform_tpu as sp
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    fs, fmin, n_bins = 22050.0, 32.703195662574764, 84
    freqs = sp.cqt_frequencies(n_bins, fmin, 12)
    k_target = 60
    tt = np.arange(n) / fs
    sig = np.stack([
        np.cos(2 * math.pi * freqs[k_target] * tt) for _ in range(batch)
    ]).astype(np.float32)
    xd = jax.device_put(sig)

    def fn(v):
        C = sp.cqt(v, fs=fs, fmin=fmin, n_bins=n_bins, hop=512)
        mag = jnp.real(C) ** 2 + jnp.imag(C) ** 2
        return (v + jnp.asarray(1e-20, v.dtype) * jnp.sum(mag).astype(v.dtype),)

    def peak(v):
        C = sp.cqt(v, fs=fs, fmin=fmin, n_bins=n_bins, hop=512)
        mag = jnp.real(C) ** 2 + jnp.imag(C) ** 2
        mid = mag.shape[-2] // 2
        return jnp.argmax(mag[0, mid]).astype(jnp.int32)

    ok = int(np.asarray(jax.jit(peak)(xd))) == k_target
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return dt / batch, ok


def bench_sosfilt(batch: int, n: int, iters: int, seed: int = 0):
    """(seconds-per-signal, rel err vs scipy fp64) for a 6th-order
    Butterworth sos cascade — the round-4 associative-scan IIR path
    (log-depth recurrence; the classical form is serial)."""
    from mixed_radix_fast_fourier_transform_tpu.ops.iir import butter, sosfilt
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import marginal_time

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    xd = jax.device_put(x)
    sos = butter(6, 0.2, output="sos")

    def fn(a):
        return (sosfilt(sos, a),)

    got = np.asarray(jax.jit(fn)(xd)[0])
    try:
        from scipy.signal import sosfilt as sp_sosfilt

        want = sp_sosfilt(np.asarray(sos), x[:2].astype(np.float64), axis=-1)
        err = float(np.max(np.abs(got[:2] - want)) / np.max(np.abs(want)))
    except Exception:  # pragma: no cover — scipy optional at bench time
        err = float("nan")
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return dt / batch, err


def bench_kalman(T: int, iters: int, seed: int = 0):
    """(parallel seconds-per-step·1e6, speedup of the associative-scan form
    over the sequential lax.scan, max abs mean diff) for a d=4 tracking
    model over T steps — the round-4 parallel-in-time smoother subsystem.

    Timing is DIRECT interleaved repeated calls (scalar-fetch-forced), not
    marginal_time chains: wrapping the associative scan in a fori_loop
    makes a second, separately compiled program of the whole scan."""
    from mixed_radix_fast_fourier_transform_tpu.ops.kalman import kalman_filter

    rng = np.random.default_rng(seed)
    d, d_obs = 4, 2
    F = np.eye(d) + 0.05 * rng.standard_normal((d, d))
    F *= 0.97 / max(np.abs(np.linalg.eigvals(F)))
    Q = 0.01 * np.eye(d)
    H = rng.standard_normal((d_obs, d))
    R = 0.1 * np.eye(d_obs)
    m0, P0 = np.zeros(d), np.eye(d)
    ys = jax.device_put(rng.standard_normal((T, d_obs)).astype(np.float32))

    Ht = jnp.asarray(H.T, jnp.float32)

    # marginal_time chains outputs into inputs, so return the predicted
    # observations (same shape as ys) — also makes the chain data-dependent
    def par(y):
        m, P = kalman_filter(F, Q, H, R, m0, P0, y, parallel=True)
        return (m @ Ht,)

    def seq(y):
        m, P = kalman_filter(F, Q, H, R, m0, P0, y, parallel=False)
        return (m @ Ht,)

    pj, sj = jax.jit(par), jax.jit(seq)
    mp = np.asarray(pj(ys)[0])
    ms = np.asarray(sj(ys)[0])
    diff = float(np.max(np.abs(mp - ms)))

    def once(fn):
        t0 = time.perf_counter()
        float(np.asarray(jnp.sum(fn(ys)[0])))  # fetch forces completion
        return time.perf_counter() - t0

    tp, ts = [], []
    for _ in range(max(iters, 3)):  # interleaved: device speed drifts
        ts.append(once(sj))
        tp.append(once(pj))
    t_par = sorted(tp)[len(tp) // 2]
    t_seq = sorted(ts)[len(ts) // 2]
    return t_par / T * 1e6, t_seq / t_par, diff


def bench_shorttime(batch: int, n: int, iters: int, seed: int = 0):
    """(ms per signal for a full ShortTimeFFT stft→istft round trip, max
    abs reconstruction err) — the round-4 frame-operator subsystem (one
    static gather + batched rfft forward; scatter-add overlap-add back)."""
    import scipy.signal as ss

    from mixed_radix_fast_fourier_transform_tpu import ShortTimeFFT
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        marginal_time,
    )

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    xd = jax.device_put(x)
    S = ShortTimeFFT(ss.windows.hann(256, sym=False), hop=64, fs=1.0)

    def fn(a):
        spec = S.stft(a)
        return (S.istft(spec, k1=n),)

    got = np.asarray(jax.jit(fn)(xd)[0])
    err = float(np.max(np.abs(got - x)))
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return dt / batch * 1e3, err


def bench_vmd(n: int, K: int, iters: int, seed: int = 0):
    """(ms per decomposition, center-frequency error vs truth) for the
    jittable frequency-domain ADMM (round-4 adaptive decomposition)."""
    from mixed_radix_fast_fourier_transform_tpu.ops.vmd import vmd
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        marginal_time,
    )

    rng = np.random.default_rng(seed)
    k = np.arange(n)
    truth = np.array([0.05, 0.15, 0.31])[:K]
    x = sum(np.cos(2 * np.pi * f * k + i) for i, f in enumerate(truth))
    x = (x + 0.02 * rng.standard_normal(n)).astype(np.float32)
    xd = jax.device_put(x)

    def fn(a):
        modes, om = vmd(a, K=K, n_iter=150)
        return (jnp.sum(modes, axis=-2),)  # same shape as input: chainable

    _, om = jax.jit(lambda a: vmd(a, K=K, n_iter=150))(xd)
    err = float(np.max(np.abs(np.sort(np.asarray(om)) - np.sort(truth))))
    dt = marginal_time(fn, (xd,), short=iters, long=5 * iters)
    return dt * 1e3, err


def bench_pfb(batch: int, n_channels: int, n_frames: int, iters: int,
              seed: int = 0):
    """(ms per signal for a full-mode PFB channelize + exact inverse, max
    abs round-trip err) — the round-4 channelizer subsystem (polyphase
    weighting + batched engine FFT forward; per-residue branch
    deconvolution back)."""
    from mixed_radix_fast_fourier_transform_tpu import (
        pfb_analysis, pfb_synthesis,
    )
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        marginal_time,
    )

    K, P = n_channels, 8
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, K * n_frames))
         + 1j * rng.standard_normal((batch, K * n_frames))
         ).astype(np.complex64)
    def rt(a):
        return pfb_synthesis(pfb_analysis(a, K, P, mode="full"), P)

    def fn(re, im):
        # chain fp32 planes: marginal_time needs real same-dtype outputs
        out = rt(re + 1j * im)
        return jnp.real(out), jnp.imag(out)

    red = jax.device_put(x.real.copy())
    imd = jax.device_put(x.imag.copy())
    got_re, got_im = jax.jit(fn)(red, imd)
    err = float(np.max(np.abs(np.asarray(got_re) + 1j * np.asarray(got_im)
                              - x)))
    dt = marginal_time(fn, (red, imd), short=iters, long=5 * iters)
    return dt / batch * 1e3, err


def bench_range_doppler(n_pulses: int, n: int, nt: int, iters: int,
                        seed: int = 0):
    """(ms per CPI for pulse compression + Doppler FFT + 2-D CA-CFAR,
    peak-location correctness flag) — the round-4 radar chain."""
    from mixed_radix_fast_fourier_transform_tpu import cfar, range_doppler
    from mixed_radix_fast_fourier_transform_tpu.utils.profiling import (
        marginal_time,
    )

    rng = np.random.default_rng(seed)
    t = np.arange(nt)
    tx = np.exp(1j * np.pi * 0.5 / nt * (t - nt / 2) ** 2)
    m = np.arange(n_pulses)[:, None]
    rx = 0.3 * (rng.standard_normal((n_pulses, n))
                + 1j * rng.standard_normal((n_pulses, n)))
    d0, fd = n // 2, 5
    rx[:, d0: d0 + nt] += tx * np.exp(2j * np.pi * fd * m / n_pulses)
    txr = jax.device_put(tx.real.astype(np.float32))
    txi = jax.device_put(tx.imag.astype(np.float32))

    def chain_fn(re, im):
        # fp32 planes in, input-shaped fp32 out (marginal_time chains it)
        txd = jax.lax.complex(txr, txi)
        Y = range_doppler(re + 1j * im, txd, window="hamming")
        p = jnp.abs(Y) ** 2
        det, th = cfar(p, num_train=6, num_guard=2, pfa=1e-4, axes=(-2, -1))
        pad = ((0, 0), (0, nt - 1))
        return (jnp.pad(p + det.astype(p.dtype), pad), jnp.pad(th, pad))

    red = jax.device_put(rx.real.astype(np.float32))
    imd = jax.device_put(rx.imag.astype(np.float32))
    pe, the = jax.jit(chain_fn)(red, imd)
    p = np.asarray(pe)[:, : n - nt + 1]
    th = np.asarray(the)[:, : n - nt + 1]
    pk = np.unravel_index(int(np.argmax(p)), p.shape)
    # p+det at the peak exceeds the threshold by >1 iff CFAR fired there
    ok = pk == (n_pulses // 2 + fd, d0) and (p[pk] - th[pk]) > 1.0
    dt = marginal_time(chain_fn, (red, imd), short=iters, long=5 * iters)
    return dt * 1e3, ok


# ---------------------------------------------------------------------------
# Output: ONE compact final line, guaranteed under COMPACT_LINE_BUDGET chars
# (headline keys + one short scalar per config, errors truncated to 40
# chars; tests/test_bench_line.py asserts the worst-case length).  The
# verbose per-config dicts go to the --detail file.
# ---------------------------------------------------------------------------

COMPACT_LINE_BUDGET = 1600
DETAIL_FILE = "bench_detail.json"


def compose_line(headline: dict, compact_configs: dict) -> str:
    """The one driver-facing line.  Guaranteed under COMPACT_LINE_BUDGET:
    if the full configs dict does not fit, configs are dropped from the END
    (lowest-priority entries last in insertion order) with a marker count."""
    line = json.dumps({**headline, "configs": compact_configs})
    if len(line) <= COMPACT_LINE_BUDGET:
        return line
    keys = list(compact_configs)
    while keys:
        keys.pop()
        trimmed = {k: compact_configs[k] for k in keys}
        trimmed["_dropped"] = len(compact_configs) - len(keys)
        line = json.dumps({**headline, "configs": trimmed})
        if len(line) <= COMPACT_LINE_BUDGET:
            return line
    return json.dumps({**headline, "configs": {"_dropped": len(compact_configs)}})


def _compact(value):
    """Short scalar for the driver line: 4 significant digits."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return value
    if value != value:  # NaN is not valid JSON
        return None
    return float(f"{value:.4g}")


def _runners():
    """Ordered (name, thunk) list.  Each thunk returns
    (compact_scalar, detail_dict, err_or_None, budget_ok).

    Order is priority order: core roofline configs first, then the
    op-level configs, then the A/B and vs-builtin re-measurements.
    """
    R = []

    def core(n, b, it):
        def run():
            stats, err = bench_config(n, b, it)
            return stats["gflops"], stats, err, True
        return run

    # --- 1. core roofline configs (headline + BASELINE contract) ---------
    R.append(("n1024_b256", core(1024, 256, 1000)))
    R.append(("n4096_b64", core(4096, 64, 500)))
    R.append(("n5040_b64", core(5040, 64, 300)))    # mixed radix 2/3/5/7
    R.append(("n10007_b16", core(10007, 16, 100)))  # Bluestein prime
    R.append(("n32768_b16", core(32768, 16, 100)))  # roofline contract size
    R.append(("n65536_b16", core(65536, 16, 100)))  # roofline contract size

    # --- 2. op-level configs ---------------------------------------------
    def _nufft3():
        # library-default dispatch (auto → dense at this space-bandwidth
        # product)
        dt, err = bench_nufft3_2d(4096, 4096, 10)
        ok = err <= 1e-4   # two chained eps~1e-6 kernel truncations
        d = {"ms_per_transform": round(dt * 1e3, 3),
             "rel_err_vs_dense_512": float(f"{err:.3g}"), "budget_ok": ok}
        return d["ms_per_transform"], d, None, ok
    R.append(("nufft3_2d_auto_m4096_k4096", _nufft3))

    def _nufft3_fast():
        # the fast path's own regime: M=K=65536 with S·X = 128π per axis —
        # the dense matrix there is 4.3e9 entries and cannot materialize
        dt, err = bench_nufft3_2d(65536, 65536, 10, s_extent=128.0,
                                  method="fast")
        ok = err <= 1e-4
        d = {"ms_per_transform": round(dt * 1e3, 3),
             "rel_err_vs_dense_512": float(f"{err:.3g}"), "budget_ok": ok}
        return d["ms_per_transform"], d, None, ok
    R.append(("nufft3_2d_fast_m65536_sbp128", _nufft3_fast))

    def _resample():
        dt, err = bench_resample_poly(65536, 16, 20)
        ok = (err != err) or err <= 1e-5   # NaN = scipy absent
        d = {"ms_per_signal": round(dt * 1e3, 3),
             "rel_err_vs_scipy": float(f"{err:.3g}"), "budget_ok": ok}
        return d["ms_per_signal"], d, None, ok
    R.append(("resample_poly_3_2_n65536", _resample))

    def _multitaper():
        dt, flat = bench_multitaper(16, 8192, 7, 50)
        ok = flat < 0.05
        d = {"ms_per_batch": round(dt * 1e3, 3),
             "psd_flatness_err": float(f"{flat:.3g}"), "budget_ok": ok}
        return d["ms_per_batch"], d, None, ok
    R.append(("multitaper_k7_16x8192", _multitaper))

    def _sosfilt():
        dt, err = bench_sosfilt(16, 65536, 20)
        ok = (err != err) or err <= 1e-4   # fp32 recurrence class
        d = {"ms_per_signal": round(dt * 1e3, 3),
             "rel_err_vs_scipy": float(f"{err:.3g}"), "budget_ok": ok}
        return d["ms_per_signal"], d, None, ok
    R.append(("sosfilt_butter6_16x65536", _sosfilt))

    def _shorttime():
        ms_sig, err = bench_shorttime(8, 16384, 50)
        ok = err <= 1e-4
        d = {"ms_per_signal": round(ms_sig, 3),
             "max_rel_err": float(f"{err:.3g}"), "budget_ok": ok}
        return d["ms_per_signal"], d, None, ok
    R.append(("shorttime_roundtrip_8x16384", _shorttime))

    def _vmd():
        ms_dec, err = bench_vmd(4096, 3, 20)
        ok = err <= 5e-3
        d = {"ms_per_decomposition": round(ms_dec, 3),
             "center_freq_err": float(f"{err:.3g}"), "budget_ok": ok}
        return d["ms_per_decomposition"], d, None, ok
    R.append(("vmd_k3_n4096", _vmd))

    def _kalman():
        us_step, speedup, diff = bench_kalman(65536, 3)
        ok = diff <= 1e-2
        d = {"us_per_step": round(us_step, 4),
             "speedup_vs_sequential_scan": round(speedup, 2),
             "max_mean_diff": float(f"{diff:.3g}"), "budget_ok": ok}
        return round(speedup, 2), d, None, ok
    R.append(("kalman_parallel_d4_T65536", _kalman))

    def _pfb():
        ms_sig, err = bench_pfb(8, 64, 256, 20)
        ok = err <= 1e-3
        d = {"ms_per_signal": round(ms_sig, 3),
             "max_abs_err": float(f"{err:.3g}"), "budget_ok": ok}
        return d["ms_per_signal"], d, None, ok
    R.append(("pfb_roundtrip_8xK64F256", _pfb))

    def _rd():
        ms_cpi, ok = bench_range_doppler(64, 4096, 128, 20)
        d = {"ms_per_cpi": round(ms_cpi, 3), "target_detected": bool(ok)}
        return d["ms_per_cpi"], d, None, bool(ok)
    R.append(("range_doppler_cfar_64x4096", _rd))

    def _cqt():
        dt, ok = bench_cqt(4, 1 << 17, 3)
        d = {"ms_per_signal": round(dt * 1e3, 3), "peak_band_ok": bool(ok)}
        return d["ms_per_signal"], d, None, bool(ok)
    R.append(("cqt_84bands_131072_b4", _cqt))

    # --- 3. prime-path A/B + extension configs ---------------------------
    def _rader_cfg():
        # default dispatch (Bluestein; rader="auto" is the opt-in lever)
        stats, err = bench_config(1009, 64, 200)
        return stats["gflops"], stats, err, True
    R.append(("n1009_b64", _rader_cfg))

    def _rader_ab():
        r = round(bench_rader_vs_bluestein(1009, 64, 200), 3)
        # informational A/B of the opt-in path; not part of the error budget
        return r, {"ratio": r}, None, True
    R.append(("speedup_rader_vs_bluestein_n1009", _rader_ab))

    def _nufft1():
        dt, err = bench_nufft(4096, 4096, 100)
        ok = err <= 2e-5
        d = {"us_per_transform": round(dt * 1e6, 1),
             "rel_err_vs_dense": float(f"{err:.3g}"), "budget_ok": ok}
        return d["us_per_transform"], d, None, ok
    R.append(("nufft1_grid_n4096_m4096", _nufft1))

    def _nufft2():
        dt, err = bench_nufft2(4096, 4096, 100)
        ok = err <= 2e-5
        d = {"us_per_transform": round(dt * 1e6, 1),
             "rel_err_vs_dense": float(f"{err:.3g}"), "budget_ok": ok}
        return d["us_per_transform"], d, None, ok
    R.append(("nufft2_grid_n4096_m4096", _nufft2))

    def _sht(L, b, it):
        def run():
            dt, err = bench_sht(L, b, it)
            ok = err <= 1e-5
            d = {"us_per_field": round(dt * 1e6 / b, 2),
                 "proj_err": float(f"{err:.3g}"), "budget_ok": ok}
            return d["us_per_field"], d, None, ok
        return run
    R.append(("sht_roundtrip_L128_b16", _sht(128, 16, 50)))
    R.append(("sht_roundtrip_L256_b16", _sht(256, 16, 20)))

    def _rfft_rt():
        gf, err = bench_rfft_roundtrip(4096, 64, 300)
        d = {"gflops": round(gf, 2), "max_rel_err": float(f"{err:.3g}")}
        return d["gflops"], d, err, True
    R.append(("rfft4096_roundtrip_b64", _rfft_rt))

    def _conv(n_sig, n_ker, b, it):
        def run():
            gf, err = bench_convolve(n_sig, n_ker, b, it)
            d = {"gflops": round(gf, 2), "max_rel_err": float(f"{err:.3g}")}
            return d["gflops"], d, err, True
        return run
    R.append(("conv4000x129_same_b64", _conv(4000, 129, 64, 200)))
    R.append(("conv65408x129_same_b256", _conv(65408, 129, 256, 20)))

    # --- 4. vs-builtin sweep --------------------------------------------
    def _vs(n, b, it):
        def run():
            r = round(bench_vs_xla_builtin(n, b, it), 3)
            return r, {"ratio": r}, None, True
        return run
    for n_r, b_r, it_r in ((1024, 256, 1000), (2048, 128, 700),
                           (4096, 64, 500), (8192, 32, 300),
                           (16384, 32, 200), (32768, 16, 150),
                           (65536, 16, 100), (10007, 16, 100)):
        R.append((f"vs_builtin_n{n_r}", _vs(n_r, b_r, it_r)))

    def _vs_rfft():
        r = round(bench_rfft_vs_builtin(4096, 64, 300), 3)
        return r, {"ratio": r}, None, True
    R.append(("vs_builtin_rfft4096", _vs_rfft))

    return R


def nvidia_smi() -> list:
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu(count: int = 1, who: str = "bench"):
    """The JAX devices, or SystemExit(2) when they are not ``count`` GPUs."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.stderr.write(f"{who}: no GPU (JAX platform is "
                         f"{devices[0].platform!r})\n")
        raise SystemExit(2)
    if len(devices) < count:
        sys.stderr.write(f"{who}: needs {count} GPUs, found {len(devices)}\n")
        raise SystemExit(2)
    return devices


def main(argv=None) -> int:
    from mixed_radix_fast_fourier_transform_tpu.utils.cache import (
        enable_persistent_cache,
    )

    ap = argparse.ArgumentParser(description="GPU benchmark: one JSON line")
    ap.add_argument("--detail", default=DETAIL_FILE,
                    help="file for the full per-config records")
    args = ap.parse_args(argv)

    dev = require_gpu()[0]
    peaks = device_peaks(dev.device_kind)
    card = nvidia_smi()[0]
    enable_persistent_cache()

    compact, detail = {}, {}
    worst_err, ext_ok, all_ran = 0.0, True, True
    for name, thunk in _runners():
        t0 = time.perf_counter()
        try:
            value, d, err, ok = thunk()
        except Exception as e:  # recorded, and the run exits non-zero
            msg = f"{type(e).__name__}: {e}"
            compact[name] = "err:" + msg[:40]
            detail[name] = {"error": msg[:2000]}
            all_ran = False
        else:
            compact[name] = _compact(value)
            detail[name] = d
            if err is not None:
                worst_err = max(worst_err, float(err))
            ext_ok = ext_ok and bool(ok)
        # progress on stderr; stdout keeps its one line
        sys.stderr.write(f"bench: {name} {time.perf_counter() - t0:.1f}s "
                         f"{compact[name]}\n")

    primary = detail.get("n1024_b256", {}).get("gflops", 0.0) or 0.0
    headline = {
        "metric": "batched_fft_gflops_n1024_fp32",
        "value": primary,
        "unit": "GFLOP/s",
        "vs_baseline": round(primary / REFERENCE_GFLOPS, 3) if primary else 0.0,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
        "max_rel_err": float(f"{worst_err:.3g}"),
        # 1e-5 budget on the core transforms AND the method-specific
        # extension budgets (per-config ok flags); a config that raised
        # fails it too
        "error_budget_ok": bool(worst_err <= 1e-5 and ext_ok and all_ran),
        "pct_fp32_peak_n32768": detail.get("n32768_b16", {}).get(
            "pct_fp32_peak"),
        "pct_fp32_peak_n65536": detail.get("n65536_b16", {}).get(
            "pct_fp32_peak"),
        "detail_file": args.detail,
    }
    with open(args.detail, "w") as f:
        json.dump({**headline, "peaks": peaks, "configs": detail}, f, indent=1)
    print(compose_line(headline, compact))
    return 0 if all_ran else 1


if __name__ == "__main__":
    sys.exit(main())
