"""Smoke run of the spectral library on NVIDIA GPUs, through its public API.

    python chip_smoke.py [--seed S]            # one GPU: engine phases + FNet-Base
    python chip_smoke.py [--seed S] --four     # four GPUs: the sharded path only

Default phases, each at a size users run and each compared with an fp64
reference on the host that is independent of the engine (numpy / scipy,
i.e. pocketfft):

* c2c mixed radix: ``sp.fft`` / ``sp.ifft`` at N=1024 b=16384, N=5040
  b=2048, N=65536 b=256;
* Bluestein: ``sp.fft`` at the prime N=10007, b=1024;
* real: ``sp.rfft`` and the ``sp.irfft`` round trip, N=4096 b=8192;
* convolution: ``sp.fft_convolve`` of 65536-sample signals with 1025 taps,
  b=256, modes full/same/valid, against ``scipy.signal.fftconvolve``;
* model: FNet-Base (hidden 768, ff 3072, 12 layers, seq 512, batch 16),
  three ``train_step`` calls; loss and gradient compared with the same
  model and parameters mixing through ``jnp.fft.fft2`` (cuFFT).

Then the engine is timed against ``jnp.fft.fft`` on the same device arrays
(median of warmed calls); the ratio is printed, it is not a gate.

``--four`` runs only the sharded path on a four-device mesh, each phase
compared with the same computation on one device: ``fft_four_step`` at
N=2^24, ``fft_convolve_sharded`` at 65536 x 4096, and the distributed
spectral-filter training step on a (2, 2) mesh.

Errors are max-abs error over the max-abs of the reference.  Every line
before the last is a record; the last line is one JSON object with
``"ok": true`` and the device.  Without a GPU, or when any phase fails its
tolerance or raises, the script exits non-zero and prints no result line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import mixed_radix_fast_fourier_transform_tpu as sp
from bench import nvidia_smi, require_gpu
from mixed_radix_fast_fourier_transform_tpu.models import fnet
from mixed_radix_fast_fourier_transform_tpu.utils.cache import (
    enable_persistent_cache,
)

ENGINE_PRECISION = "HIGHEST: fp32 off the tensor cores"
TOL = 1e-5          # NUMERICS.md core-engine budget
GRAD_TOL = 1e-4

# (n, batch) per phase at full size; tests pass small ones
C2C_SIZES = ((1024, 16384), (5040, 2048), (65536, 256))
BLUESTEIN_SIZE = (10007, 1024)
REAL_SIZE = (4096, 8192)
CONV_SIZE = (65536, 1025, 256)  # signal length, taps, batch
FNET_BASE = dict(hidden=768, ff_dim=3072, n_layers=12, seq=512, batch=16)
FOUR_STEP_SIZE = (1 << 24, 16)
SHARDED_CONV_SIZE = (65536, 1025, 4096)
FILTER_STEP_SIZE = (256, 4096)  # n1 (N = n1^2), batch


def relerr(got, want) -> float:
    """max |got - want| / max |want|, in float64 on the host."""
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def device_relerr(got, want) -> float:
    """:func:`relerr` reduced on the device holding ``want`` (for arrays
    too large to bring to the host)."""
    got = jax.device_put(got, next(iter(want.devices())))
    return float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))


def compile_fn(fn, *args):
    """Jit, lower and compile ``fn`` for ``args``.  Returns the compiled
    function and a dict: ``lower_s`` (tracing, which builds the plans, and
    lowering), ``compile_s`` (XLA's compile, or its fetch from the
    persistent cache) and ``mem_bytes`` (device bytes from
    ``memory_analysis()``)."""
    t0 = time.perf_counter()
    lowered = jax.jit(fn).lower(*args)
    t1 = time.perf_counter()
    compiled = lowered.compile()
    t2 = time.perf_counter()
    mem = compiled.memory_analysis()
    nbytes = None
    if mem is not None:
        nbytes = int(
            mem.argument_size_in_bytes + mem.output_size_in_bytes
            + mem.temp_size_in_bytes - mem.alias_size_in_bytes
        )
    return compiled, {"lower_s": round(t1 - t0, 3),
                      "compile_s": round(t2 - t1, 3), "mem_bytes": nbytes}


def record(phase, err, tol, cost, precision=ENGINE_PRECISION, **extra):
    """One check's line: ``err`` against ``tol`` plus the ``cost`` dict of
    :func:`compile_fn`."""
    return {"phase": phase, "err": err, "tol": tol, "ok": bool(err <= tol),
            **cost, "precision": precision, **extra}


def _complex_input(rng, batch, n):
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    return x.astype(np.complex64)


def phase_c2c(rng, n, batch):
    """``sp.fft`` and ``sp.ifft`` against numpy's fp64 transforms."""
    x = _complex_input(rng, batch, n)
    xd = jax.device_put(x)
    x64 = x.astype(np.complex128)
    out = []
    for name, fn, ref in (("fft", sp.fft, np.fft.fft),
                          ("ifft", sp.ifft, np.fft.ifft)):
        compiled, cost = compile_fn(fn, xd)
        err = relerr(compiled(xd), ref(x64, axis=-1))
        out.append(record(f"c2c_{name}_n{n}_b{batch}", err, TOL, cost))
    return out


def phase_bluestein(rng, n, batch):
    """``sp.fft`` at a prime length (chirp-z through the engine)."""
    x = _complex_input(rng, batch, n)
    xd = jax.device_put(x)
    compiled, cost = compile_fn(sp.fft, xd)
    err = relerr(compiled(xd), np.fft.fft(x.astype(np.complex128), axis=-1))
    return [record(f"bluestein_fft_n{n}_b{batch}", err, TOL, cost)]


def phase_real(rng, n, batch):
    """``sp.rfft`` against numpy, and the ``sp.irfft`` round trip against
    the input."""
    x = rng.standard_normal((batch, n)).astype(np.float32)
    xd = jax.device_put(x)
    fwd, cost = compile_fn(sp.rfft, xd)
    spec = fwd(xd)
    out = [record(f"rfft_n{n}_b{batch}", relerr(spec, np.fft.rfft(
        x.astype(np.float64), axis=-1)), TOL, cost)]
    inv, cost = compile_fn(partial(sp.irfft, n=n), spec)
    out.append(record(f"irfft_roundtrip_n{n}_b{batch}",
                      relerr(inv(spec), x), TOL, cost))
    return out


def phase_convolve(rng, n, taps, batch):
    """``sp.fft_convolve`` in every linear mode against scipy's fp64
    ``fftconvolve``."""
    from scipy.signal import fftconvolve

    x = rng.standard_normal((batch, n)).astype(np.float32)
    k = rng.standard_normal((1, taps)).astype(np.float32)
    xd, kd = jax.device_put(x), jax.device_put(k)
    out = []
    for mode in ("full", "same", "valid"):
        compiled, cost = compile_fn(partial(sp.fft_convolve, mode=mode),
                                       xd, kd)
        want = fftconvolve(x.astype(np.float64), k.astype(np.float64),
                           mode=mode, axes=-1)
        out.append(record(f"fft_convolve_{mode}_n{n}_k{taps}_b{batch}",
                          relerr(compiled(xd, kd), want), TOL, cost))
    return out


def cufft_mix(x):
    """FNet token mixing through XLA's own FFT (cuFFT on the GPU)."""
    return jnp.real(jnp.fft.fft2(x))


def cufft_fnet_loss(params, x, target):
    """``fnet.loss_fn`` with the engine's mixing replaced by
    :func:`cufft_mix`: the reference model, same layers and parameters."""
    for p in params["layers"]:
        x = fnet._encoder_layer(p, x, cufft_mix(x))
    return jnp.mean((x - target) ** 2)


def phase_fnet(key, hidden, ff_dim, n_layers, seq, batch, steps=3):
    """FNet training through ``models.fnet``: first-step loss and gradient
    against :func:`cufft_fnet_loss`, then ``steps`` SGD steps whose losses
    must be finite.  Everything runs under
    ``jax.default_matmul_precision("highest")``, so the FFN products are
    fp32 in both."""
    k_p, k_x, k_t = jax.random.split(key, 3)
    params = fnet.init_fnet(k_p, hidden, ff_dim, n_layers)
    x = jax.random.normal(k_x, (batch, seq, hidden), jnp.float32)
    target = jax.random.normal(k_t, (batch, seq, hidden), jnp.float32)
    name = f"fnet_h{hidden}_ff{ff_dim}_l{n_layers}_s{seq}_b{batch}"
    precision = "highest (FFN fp32); engine " + ENGINE_PRECISION
    with jax.default_matmul_precision("highest"):
        ours, cost_g = compile_fn(jax.value_and_grad(fnet.loss_fn),
                                  params, x, target)
        ref, _ = compile_fn(jax.value_and_grad(cufft_fnet_loss),
                            params, x, target)
        step, cost = compile_fn(fnet.train_step, params, x, target)
    loss, g = ours(params, x, target)
    loss_ref, g_ref = ref(params, x, target)
    grad_err = tree_relerr(g, g_ref)
    loss_err = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    losses = []
    p = params
    for _ in range(steps):
        p, step_loss = step(p, x, target)
        losses.append(float(step_loss))
    nonfinite = int(np.sum(~np.isfinite(losses)))
    return [
        record(f"{name}_loss", loss_err, TOL, cost_g, precision,
               loss=float(loss), loss_ref=float(loss_ref)),
        record(f"{name}_grad", grad_err, GRAD_TOL, cost_g, precision),
        # err counts non-finite losses over the steps
        record(f"{name}_steps", nonfinite, 0, cost, precision,
               losses=losses),
    ]


def global_norm(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return jnp.sqrt(sum(jnp.sum(jnp.square(a)) for a in leaves))


def tree_relerr(got, want) -> float:
    """Global norm of ``got - want`` over the global norm of ``want``."""
    diff = jax.tree_util.tree_map(lambda a, b: a - b, got, want)
    return float(global_norm(diff) / global_norm(want))


def time_vs_builtin(rng, n, batch, calls=25):
    """Median seconds of ``sp.fft`` and ``jnp.fft.fft`` on the same device
    array, ``calls`` warmed calls each, interleaved."""
    xd = jax.device_put(_complex_input(rng, batch, n))
    ours, theirs = jax.jit(sp.fft), jax.jit(jnp.fft.fft)
    for f in (ours, theirs):
        f(xd).block_until_ready()
    t_ours, t_theirs = [], []
    for _ in range(calls):
        for f, acc in ((ours, t_ours), (theirs, t_theirs)):
            t0 = time.perf_counter()
            f(xd).block_until_ready()
            acc.append(time.perf_counter() - t0)
    a, b = float(np.median(t_ours)), float(np.median(t_theirs))
    return {"timing": f"fft_n{n}_b{batch}", "engine_s": a, "jnp_fft_s": b,
            "jnp_fft_over_engine": b / a, "calls": calls}


# ---------------------------------------------------------------------------
# Four devices: the sharded path, each compared with one device.
# ---------------------------------------------------------------------------

def phase_four_step(mesh, n, batch, seed):
    """``fft_four_step`` on ``mesh`` (seq axis) against ``jnp.fft.fft`` on
    one device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mixed_radix_fast_fourier_transform_tpu.parallel import fft_four_step

    k_r, k_i = jax.random.split(jax.random.PRNGKey(seed))
    make = jax.jit(
        lambda: jax.lax.complex(
            jax.random.normal(k_r, (batch, n), jnp.float32),
            jax.random.normal(k_i, (batch, n), jnp.float32)),
        out_shardings=NamedSharding(mesh, P(None, "seq")))
    x = make()
    compiled, cost = compile_fn(partial(fft_four_step, mesh=mesh), x)
    got = compiled(x)
    x1 = jax.device_put(x, mesh.devices.flat[0])
    want = jax.jit(jnp.fft.fft)(x1)
    return [record(f"fft_four_step_n{n}_b{batch}_mesh{mesh.devices.shape}",
                   device_relerr(got, want), TOL, cost)]


def phase_sharded_convolve(mesh, n, taps, batch, seed):
    """``fft_convolve_sharded`` ('same') against ``sp.fft_convolve`` on one
    device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mixed_radix_fast_fourier_transform_tpu.parallel import (
        fft_convolve_sharded,
    )

    k_x, k_k = jax.random.split(jax.random.PRNGKey(seed + 1))
    x = jax.jit(lambda: jax.random.normal(k_x, (batch, n), jnp.float32),
                out_shardings=NamedSharding(mesh, P(None, "seq")))()
    k = np.asarray(jax.random.normal(k_k, (taps,), jnp.float32))
    compiled, cost = compile_fn(
        lambda v: fft_convolve_sharded(v, k, mesh, mode="same"), x)
    got = compiled(x)
    x1 = jax.device_put(x, mesh.devices.flat[0])
    want = jax.jit(lambda v: sp.fft_convolve(v, k[None, :], mode="same"))(x1)
    return [record(
        f"fft_convolve_sharded_same_n{n}_k{taps}_b{batch}"
        f"_mesh{mesh.devices.shape}",
        device_relerr(got, want), TOL, cost)]


def hermitian_gain(params, n):
    """Real-filter (rfft) gains equivalent to a full-spectrum complex gain:
    Re(ifft(X·G)) = irfft(X[:n/2+1]·H) with H[k] = (G[k] + conj G[-k]) / 2."""
    g = np.asarray(params["gain_re"]) + 1j * np.asarray(params["gain_im"])
    h = 0.5 * (g + np.conj(np.roll(g[::-1], 1)))[: n // 2 + 1]
    return {"gain_re": jnp.asarray(h.real, jnp.float32),
            "gain_im": jnp.asarray(h.imag, jnp.float32),
            "bias": jnp.asarray(params["bias"])}


def complex_filter_loss(params, x, target):
    """The distributed spectral filter's loss on one device through
    ``jnp.fft`` (cuFFT on the GPU): Re(ifft(fft(x)·G)) + bias against
    ``target``."""
    gain = jax.lax.complex(params["gain_re"], params["gain_im"])
    y = jnp.real(jnp.fft.ifft(jnp.fft.fft(x) * gain)) + params["bias"]
    return jnp.mean((y - target) ** 2)


def phase_distributed_filter(mesh, n1, batch, seed):
    """The sharded spectral-filter training step of ``__graft_entry__``
    against one device: its loss against ``models.train_step`` with the
    equivalent real filter, its parameter gradients (which ride the
    reverse all-to-alls) against :func:`complex_filter_loss`'s, and its
    update against ``params - lr·grads``."""
    import __graft_entry__ as graft
    from mixed_radix_fast_fourier_transform_tpu import models

    t0 = time.perf_counter()
    out = graft.distributed_filter_step(mesh, n1, batch, seed)
    loss = float(out["loss"])
    cost = {"step_s": round(time.perf_counter() - t0, 3)}  # incl. compile
    dev = mesh.devices.flat[0]
    p1, x1, t1, grads, new_p = jax.device_put(
        (out["params"], out["x"], out["target"], out["grads"],
         out["new_params"]), dev)
    _, loss_ref = jax.jit(models.train_step)(
        jax.device_put(hermitian_gain(out["params"], n1 * n1), dev), x1, t1)
    g_ref = jax.jit(jax.grad(complex_filter_loss))(p1, x1, t1)
    want_p = jax.tree_util.tree_map(lambda p, g: p - 1e-2 * g, p1, grads)
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    name = f"filter_train_step_n{n1 * n1}_b{batch}_mesh{mesh.devices.shape}"
    return [
        record(f"{name}_loss",
               abs(loss - float(loss_ref)) / abs(float(loss_ref)), TOL, cost,
               loss=loss, loss_ref=float(loss_ref),
               peak_bytes_in_use_dev0=peak),
        record(f"{name}_grad", tree_relerr(grads, g_ref), GRAD_TOL, cost),
        record(f"{name}_update", tree_relerr(new_p, want_p), TOL, cost),
    ]


# ---------------------------------------------------------------------------

def run_phases(phases):
    """Run ``(name, thunk)`` phases in turn; print each record.  Returns
    the number of failed records (a raised phase counts as failed)."""
    failed = 0
    for name, thunk in phases:
        try:
            recs = thunk()
        except Exception as e:  # a phase that raises fails the run
            print(json.dumps({"phase": name, "ok": False,
                              "error": f"{type(e).__name__}: {e}"[:2000]}),
                  flush=True)
            failed += 1
            continue
        for r in recs:
            print(json.dumps(r), flush=True)
            failed += not r["ok"]
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    devices = require_gpu(4 if args.four else 1, who="chip_smoke")
    enable_persistent_cache()
    for line in nvidia_smi():
        print(f"nvidia-smi: {line}", flush=True)
    print(f"device_kind: {devices[0].device_kind}  count: {len(devices)}",
          flush=True)
    rng = np.random.default_rng(args.seed)

    if args.four:
        from mixed_radix_fast_fourier_transform_tpu.parallel import make_mesh

        line = make_mesh((1, 4), devices=devices[:4])
        square = make_mesh((2, 2), devices=devices[:4])
        phases = [
            ("fft_four_step", lambda: phase_four_step(
                line, *FOUR_STEP_SIZE, args.seed)),
            ("fft_convolve_sharded", lambda: phase_sharded_convolve(
                line, *SHARDED_CONV_SIZE, args.seed)),
            ("distributed_filter", lambda: phase_distributed_filter(
                square, *FILTER_STEP_SIZE, args.seed)),
        ]
    else:
        phases = [(f"c2c_n{n}", partial(phase_c2c, rng, n, b))
                  for n, b in C2C_SIZES]
        phases += [
            ("bluestein", partial(phase_bluestein, rng, *BLUESTEIN_SIZE)),
            ("real", partial(phase_real, rng, *REAL_SIZE)),
            ("convolve", partial(phase_convolve, rng, *CONV_SIZE)),
            ("fnet_base", partial(phase_fnet, jax.random.PRNGKey(args.seed),
                                  **FNET_BASE)),
        ]
    failed = run_phases(phases)

    if not args.four:
        for n, b in C2C_SIZES + (BLUESTEIN_SIZE,):
            print(json.dumps(time_vs_builtin(rng, n, b)), flush=True)
    if failed:
        sys.stderr.write(f"chip_smoke: {failed} check(s) failed\n")
        return 1
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
