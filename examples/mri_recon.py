"""MRI-style image reconstruction from radial k-space samples.

End-to-end showcase of the non-uniform FFT stack: a synthetic phantom is
sampled along radial k-space spokes (2-D type-2 NUFFT), then reconstructed
two ways:

  1. adjoint ("gridding") reconstruction with radial density compensation
     — one 2-D type-1 NUFFT;
  2. iterative least-squares via :func:`nufft_lsq_2d` — CG on the
     block-Toeplitz normal equations, each iteration one padded fft2.

Run: python examples/mri_recon.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import mixed_radix_fast_fourier_transform_tpu as sp  # noqa: E402


def phantom(n: int) -> np.ndarray:
    """Tiny Shepp-Logan-flavoured phantom: nested ellipses."""
    yy, xx = np.mgrid[-1 : 1 : n * 1j, -1 : 1 : n * 1j]
    img = np.zeros((n, n))
    for (cx, cy, ax, ay, val) in [
        (0.0, 0.0, 0.75, 0.9, 1.0),
        (0.0, 0.05, 0.65, 0.8, -0.6),
        (0.2, 0.2, 0.15, 0.25, 0.4),
        (-0.25, -0.2, 0.2, 0.15, 0.35),
    ]:
        img[((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0] += val
    return img


def radial_kspace(n: int, spokes: int, per_spoke: int):
    """Radial k-space trajectory.  The image's centered pixels play the
    modes of the 2-D NUFFT, so a k-space coordinate kappa (cycles per FOV,
    |kappa| <= n/2) is the point x = 2*pi*kappa/n; spokes cover the inscribed
    disc (the corners of k-space are unsampled — the usual radial MRI
    situation)."""
    th = np.pi * np.arange(spokes) / spokes
    kappa = np.linspace(-n / 2, n / 2, per_spoke, endpoint=False)
    kx = np.outer(np.cos(th), kappa).ravel() * 2 * np.pi / n
    ky = np.outer(np.sin(th), kappa).ravel() * 2 * np.pi / n
    # density compensation ~ |kappa| (ram-lak), normalized to mean 1
    w = np.abs(np.outer(np.ones(spokes), kappa)).ravel()
    w = w / w.sum() * len(w)
    return (np.mod(kx, 2 * np.pi).astype(np.float32),
            np.mod(ky, 2 * np.pi).astype(np.float32),
            w.astype(np.float32))


def psnr(a, b):
    mse = np.mean((a - b) ** 2)
    return 10 * np.log10(np.max(b) ** 2 / mse) if mse > 0 else np.inf


def main():
    n = 32
    img = phantom(n)
    spokes = 64
    x, y, w = radial_kspace(n, spokes=spokes, per_spoke=2 * n)
    print(f"phantom {n}x{n}, {len(x)} radial k-space samples "
          f"({spokes} spokes x {2*n} points)")

    # forward "scanner": the image's centered pixels are the NUFFT modes, so
    # type 2 evaluates the k-space signal along the spokes
    b = np.asarray(sp.nufft2_2d(x, y, img.astype(np.complex64), isign=-1))

    # 1. adjoint + density compensation ("gridding" reconstruction)
    adj = np.asarray(
        sp.nufft1_2d(x, y, (b * w).astype(np.complex64), (n, n), isign=+1)
    ) / len(x)
    print(f"  adjoint+DCF reconstruction: PSNR {psnr(np.real(adj), img):.1f} dB")

    # 2. iterative least squares (CG on the Toeplitz normal equations);
    # the unsampled k-space corners are the system's null space — CG leaves
    # them at zero, so the result approaches the disc-truncation oracle
    rec = np.asarray(sp.nufft_lsq_2d(x, y, b.astype(np.complex64), (n, n),
                                     weights=w, iters=25, isign=-1))
    print(f"  CG least-squares (25 iters):  PSNR {psnr(np.real(rec), img):.1f} dB")

    # oracle: zero the k-space disc complement (what radial can never see)
    k = np.arange(-(n // 2), n // 2)
    K1, K2 = np.meshgrid(k, k, indexing="ij")
    spec = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(img)))
    spec[K1**2 + K2**2 > (n / 2) ** 2] = 0
    oracle = np.real(np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(spec))))
    print(f"  disc-truncation oracle:       PSNR {psnr(oracle, img):.1f} dB")


if __name__ == "__main__":
    main()
