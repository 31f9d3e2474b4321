"""mixed_radix_fast_fourier_transform_tpu — mixed-radix spectral library in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the reference C
library `Tugbars/Mixed-Radix-Fast-Fourier-Transform` (highSpeedFFT): plan-based
complex 1-D FFTs over mixed-radix factorizations, Bluestein's chirp-z transform
for arbitrary lengths, packed real-input rFFT/irFFT, and FFT-based convolution
— plus extensions the reference lacks: batching, N-D transforms,
autodiff, and mesh-sharded distributed transforms over several devices.

Public API (numpy.fft-flavoured):
    fft, ifft, fft2, ifft2, fftn, ifftn
    rfft, irfft, rfftn, irfftn
    fft_convolve, fft_correlate
    fftfreq, rfftfreq, fftshift, ifftshift
    plan-level: get_plan, build_complex_plan, build_real_plan, clear_plan_cache

Reference-compatible API (plan objects, unnormalized inverse, C-style names):
    from mixed_radix_fast_fourier_transform_tpu import compat
"""

from .ops.fft import (
    fft,
    ifft,
    fft2,
    ifft2,
    fftn,
    ifftn,
    fftfreq,
    rfftfreq,
    fftshift,
    ifftshift,
    dht,
    idht,
)
from .ops.rfft import rfft, irfft, rfftn, irfftn, rfft2, irfft2, hfft, ihfft
from .ops.rfft import hfft2, ihfft2, hfftn, ihfftn
from .ops.convolve import fft_convolve, fft_convolve2, fft_convolven, fft_correlate, fft_oaconvolve
from .ops.convolve import convolve, correlate, fftconvolve, oaconvolve, convolve2d, correlate2d
from .ops.shorttime import ShortTimeFFT, check_COLA, check_NOLA, closest_STFT_dual_window
from .ops.stft import stft, istft, spectrogram, get_window, dpss, griffinlim, phase_vocoder, time_stretch, pitch_shift
from .ops.cqt import cqt, cqt_frequencies, icqt
from .ops.tfr import (
    wigner_ville, ssq_cwt, ssq_stft, issq_cwt, issq_stft,
    reassigned_spectrogram, stockwell, istockwell, ambiguity,
    cohen_class, choi_williams, xwigner_ville,
)
from .ops.register import phase_cross_correlation, fourier_shift, unwrap_phase_2d
from .ops.ndimage import fourier_gaussian, fourier_uniform, fourier_ellipsoid, wiener
from .ops.tomo import radon, iradon
from .ops.radar import pulse_compression, range_doppler, cfar
from .ops.beamform import (
    steering_vector, spatial_covariance, bartlett_spectrum,
    mvdr_spectrum, mvdr_weights, music_doa,
)
from .ops.scattering import scattering1d, scattering2d
from .ops.waveforms import chirp, sweep_poly, gausspulse, sawtooth, square, unit_impulse
from .ops.feature import (
    spectral_centroid, spectral_bandwidth, spectral_rolloff,
    spectral_flatness, spectral_contrast, zero_crossing_rate, rms,
    specaugment, chroma_filterbank, chroma_stft, onset_strength, tempo,
    delta, beat_track, decompose, trim, split, mu_law_encode, mu_law_decode,
    power_to_db, db_to_power, amplitude_to_db, db_to_amplitude,
    chroma_cqt, tonnetz, gcc_phat, lpc,
)
from .ops.mel import mel_filterbank, mel_frequencies, melspectrogram, mfcc, hz_to_mel, mel_to_hz, mel_to_stft, mel_to_audio, hpss, yin, pyin, pcen, A_weighting, mfcc_to_mel, mfcc_to_audio
from .ops.czt import czt, zoom_fft, czt_points
from .ops.fht import fht, ifht, fhtoffset, fwht, ifwht
from .ops.dct import dct, idct, dst, idst, dctn, idctn, dstn, idstn
from .ops.signal import hilbert, periodogram, welch, csd, coherence, tfestimate, spectral_diff, poisson_solve, resample, resample_poly, upfirdn, lombscargle, multitaper, rceps, cceps, icceps, minimum_phase, firwin, freqz, kaiser_atten, kaiser_beta, hilbert2, remez, detrend, decimate, savgol_coeffs, savgol_filter, group_delay, deconvolve
from .ops.iir import (
    butter, cheby1, cheby2, ellip, bessel, iirfilter,
    buttap, cheb1ap, cheb2ap, ellipap, besselap,
    buttord, cheb1ord, cheb2ord, ellipord,
    iirnotch, iirpeak, iircomb,
    bilinear_zpk, lp2lp_zpk, lp2hp_zpk, lp2bp_zpk, lp2bs_zpk,
    zpk2tf, tf2zpk, zpk2sos, sos2zpk, tf2sos, sos2tf,
    lfilter, sosfilt, filtfilt, sosfiltfilt, lfilter_zi, sosfilt_zi,
    freqs, freqs_zpk, sosfreqz,
    normalize, bilinear, lp2lp, lp2hp, lp2bp, lp2bs,
    freqz_zpk, freqz_sos, iirdesign, lfiltic, findfreqs,
    unique_roots, residue, residuez, invres, invresz, BadCoefficients,
    band_stop_obj,
)
from .ops.lticlasses import (
    lti, dlti, TransferFunction, ZerosPolesGain, StateSpace, place_poles,
)
from .ops.emd import emd, eemd, hilbert_huang
from .ops.vmd import vmd
from .ops.ewt import ewt, ewt_boundaries
from .ops.hos import bispectrum, bicoherence
from .ops.dwt import wavelet_denoise, wavelet_denoise2, cycle_spin
from .ops.signal import goertzel
from .ops.subspace import corr_matrix, music, root_music, esprit, prony, pisarenko
from .ops.datadriven import ssa, dmd, dmd_reconstruct
from .ops.kalman import kalman_filter, kalman_smoother
from .ops.adaptive import lms_filter, nlms_filter, rls_filter
from .ops.ar import levinson, aryule, arburg, ar_psd
from .ops.signal import thd, sinad, sfdr, enob
from .ops import windows
from .ops.auditory import erb_space, gammatone_filterbank, gammatonegram, modulation_spectrum
from .ops.signal import (
    kaiserord, firwin2, firls, gammatone,
    max_len_seq, correlation_lags, vectorstrength,
    envelope, firwin_2d,
)
from .ops.peaks import (
    find_peaks, find_peaks_cwt, peak_prominences, peak_widths,
    argrelmin, argrelmax, argrelextrema,
    medfilt, medfilt2d, order_filter,
)
from .ops.czt import CZT, ZoomFFT
from .ops.convolve import choose_conv_method
from .ops.splines import (
    gauss_spline, cspline1d, qspline1d, cspline1d_eval, qspline1d_eval,
    cspline2d, qspline2d, symiirorder1, symiirorder2, sepfir2d, spline_filter,
)
from .ops.ltisys import (
    tf2ss, ss2tf, zpk2ss, ss2zpk, abcd_normalize, cont2discrete,
    dlsim, dstep, dimpulse, dfreqresp, dbode,
    lsim, step, impulse, freqresp, bode,
)
from .ops.mdct import mdct, imdct, mdct_window
from .ops.pfb import (
    pfb_analysis, pfb_synthesis, pfb_prototype, pfb_frequencies,
)
from .ops.cwt import cwt, ricker, morlet2, cwt_tc, tc_scales, xwt, wct
from .ops.dwt import (dwt, dwt2, dwt_max_level, idwt, idwt2, iswt, iswt2,
                      swt, swt2, wavedec, wavedec2, waverec, waverec2,
                      wpdec, wprec, wpdec2, wprec2)
from .ops.dtcwt import dtcwt, dtcwt2, idtcwt, idtcwt2
from .ops.frft import frft, frft2, ifrft
from .ops.chebyshev import (
    cheb_diff,
    cheb_diff_coef,
    cheb_eval,
    cheb_points,
    cheb_transform,
    icheb_transform,
)
from .ops.sht import isht, isht_recurrence, poisson_solve_sphere, sht, sht_recurrence, sht_grid, sphere_convolve, sphere_div, sphere_grad, sphere_helmholtz, vsht, ivsht, sphere_laplacian, sphere_vort, rotate_sht
from .ops.nufft import (
    nudft1,
    nudft1_2d,
    nudft1_3d,
    nudft2,
    nudft2_2d,
    nudft2_3d,
    nufft1,
    nufft1_2d,
    nufft1_3d,
    nufft2,
    nufft2_2d,
    nufft2_3d,
    nufft3,
    nufft3_2d,
    nufft3_3d,
    nufft_lsq,
    nufft_lsq_2d,
    nufft_lsq_3d,
)
from .plan import (
    BluesteinPlan,
    MixedRadixPlan,
    RaderPlan,
    RealPlan,
    build_bluestein_plan,
    build_complex_plan,
    build_mixed_radix_plan,
    build_rader_plan,
    build_real_plan,
    clear_plan_cache,
    get_plan,
)
from .utils.config import DEFAULT_CONFIG, SpectralConfig
from .utils.factorize import (
    dividebyN,
    next_fast_len,
    next_pow2,
    plan_stages,
    prev_fast_len,
    prime_factors,
)

__version__ = "0.1.0"

__all__ = [
    "fft", "ifft", "fft2", "ifft2", "fftn", "ifftn",
    "rfft", "rfft2", "irfft2", "hfft", "ihfft", "irfft", "rfftn", "irfftn",
    "hfft2", "ihfft2", "hfftn", "ihfftn",
    "fft_convolve", "fft_convolve2", "fft_convolven", "fft_correlate", "fft_oaconvolve",
    "convolve", "correlate", "fftconvolve", "oaconvolve", "convolve2d", "correlate2d",
    "ShortTimeFFT", "check_COLA", "check_NOLA", "closest_STFT_dual_window",
    "stft", "istft", "spectrogram", "get_window", "dpss", "griffinlim", "phase_vocoder", "time_stretch", "pitch_shift", "cqt", "cqt_frequencies", "icqt", "mel_filterbank", "mel_frequencies", "melspectrogram", "mfcc", "hz_to_mel", "mel_to_hz", "mel_to_stft", "mel_to_audio", "hpss", "yin", "pyin", "pcen", "A_weighting", "mfcc_to_mel", "mfcc_to_audio", "hilbert2",
    "spectral_centroid", "spectral_bandwidth", "spectral_rolloff", "spectral_flatness", "spectral_contrast", "zero_crossing_rate", "rms", "specaugment", "chroma_filterbank", "chroma_stft", "onset_strength", "tempo", "delta", "beat_track", "decompose", "trim", "split", "mu_law_encode", "mu_law_decode", "power_to_db", "db_to_power", "amplitude_to_db", "db_to_amplitude", "chroma_cqt", "tonnetz", "gcc_phat", "lpc",
    "chirp", "sweep_poly", "gausspulse", "sawtooth", "square", "unit_impulse", "phase_cross_correlation", "fourier_shift", "unwrap_phase_2d", "fourier_gaussian", "fourier_uniform", "fourier_ellipsoid", "wiener", "radon", "iradon", "pulse_compression", "range_doppler", "cfar", "steering_vector", "spatial_covariance", "bartlett_spectrum", "mvdr_spectrum", "mvdr_weights", "music_doa", "wigner_ville", "ssq_cwt", "ssq_stft", "issq_cwt", "issq_stft", "reassigned_spectrogram", "stockwell", "istockwell", "ambiguity", "cohen_class", "choi_williams", "xwigner_ville", "scattering1d", "scattering2d",
    "czt", "zoom_fft", "czt_points", "fht", "ifht", "fhtoffset", "fwht", "ifwht", "dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn", "hilbert", "periodogram", "welch", "csd", "coherence", "tfestimate", "spectral_diff", "poisson_solve", "resample", "resample_poly", "upfirdn", "lombscargle", "multitaper", "rceps", "cceps", "icceps", "minimum_phase", "firwin", "freqz", "kaiser_atten", "kaiser_beta", "remez", "detrend", "decimate", "savgol_coeffs", "savgol_filter", "group_delay", "deconvolve",
    "mdct", "imdct", "mdct_window", "pfb_analysis", "pfb_synthesis", "pfb_prototype", "pfb_frequencies", "cwt", "ricker", "morlet2", "cwt_tc", "tc_scales", "xwt", "wct", "dwt", "idwt", "dwt2", "idwt2", "wavedec", "waverec", "wavedec2", "waverec2", "swt", "iswt", "swt2", "iswt2", "wpdec", "wprec", "wpdec2", "wprec2", "dwt_max_level", "dtcwt", "idtcwt", "dtcwt2", "idtcwt2", "frft", "ifrft", "frft2",
    "nufft1", "nufft2", "nufft3", "nufft3_2d", "nufft3_3d", "nudft1", "nudft2", "nufft_lsq", "nufft_lsq_2d", "nufft_lsq_3d",
    "nufft1_2d", "nufft2_2d", "nudft1_2d", "nudft2_2d",
    "nufft1_3d", "nufft2_3d", "nudft1_3d", "nudft2_3d",
    "sht", "isht", "sht_grid", "sphere_laplacian", "poisson_solve_sphere", "sphere_convolve", "sphere_grad", "sphere_div", "sphere_vort", "sphere_helmholtz", "vsht", "ivsht", "rotate_sht", "sht_recurrence", "isht_recurrence",
    "cheb_points", "cheb_transform", "icheb_transform", "cheb_diff",
    "cheb_diff_coef", "cheb_eval",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift", "prev_fast_len", "dht", "idht",
    "MixedRadixPlan", "BluesteinPlan", "RaderPlan", "RealPlan",
    "build_mixed_radix_plan", "build_bluestein_plan", "build_rader_plan",
    "build_complex_plan", "build_real_plan", "get_plan", "clear_plan_cache",
    "SpectralConfig", "DEFAULT_CONFIG",
    "prime_factors", "plan_stages", "dividebyN", "next_pow2", "next_fast_len",
    # filter design + application (scipy.signal parity wave)
    "butter", "cheby1", "cheby2", "ellip", "bessel", "iirfilter",
    "buttap", "cheb1ap", "cheb2ap", "ellipap", "besselap",
    "buttord", "cheb1ord", "cheb2ord", "ellipord",
    "iirnotch", "iirpeak", "iircomb",
    "bilinear_zpk", "lp2lp_zpk", "lp2hp_zpk", "lp2bp_zpk", "lp2bs_zpk",
    "zpk2tf", "tf2zpk", "zpk2sos", "sos2zpk", "tf2sos", "sos2tf",
    "lfilter", "sosfilt", "filtfilt", "sosfiltfilt", "lfilter_zi", "sosfilt_zi",
    "freqs", "freqs_zpk", "sosfreqz",
    "normalize", "bilinear", "lp2lp", "lp2hp", "lp2bp", "lp2bs",
    "freqz_zpk", "freqz_sos", "iirdesign", "lfiltic", "findfreqs",
    "unique_roots", "residue", "residuez", "invres", "invresz",
    "BadCoefficients", "band_stop_obj",
    # LTI classes + pole placement
    "lti", "dlti", "TransferFunction", "ZerosPolesGain", "StateSpace",
    "place_poles",
    "emd", "eemd", "hilbert_huang", "vmd", "ewt", "ewt_boundaries", "bispectrum", "bicoherence", "wavelet_denoise", "wavelet_denoise2", "cycle_spin", "goertzel",
    "corr_matrix", "music", "root_music", "esprit", "prony", "pisarenko",
    "ssa", "dmd", "dmd_reconstruct", "kalman_filter", "kalman_smoother", "lms_filter", "nlms_filter", "rls_filter",
    "levinson", "aryule", "arburg", "ar_psd", "thd", "sinad", "sfdr", "enob", "windows", "erb_space", "gammatone_filterbank", "gammatonegram", "modulation_spectrum",
    # FIR + measurement utilities
    "kaiserord", "firwin2", "firls", "gammatone",
    "max_len_seq", "correlation_lags", "vectorstrength",
    "envelope", "firwin_2d",
    # peak analysis + rank filters
    "find_peaks", "find_peaks_cwt", "peak_prominences", "peak_widths",
    "argrelmin", "argrelmax", "argrelextrema",
    "medfilt", "medfilt2d", "order_filter",
    "CZT", "ZoomFFT", "choose_conv_method",
    # B-splines
    "gauss_spline", "cspline1d", "qspline1d", "cspline1d_eval",
    "qspline1d_eval", "cspline2d", "qspline2d", "symiirorder1",
    "symiirorder2", "sepfir2d", "spline_filter",
    # LTI toolbox (functional)
    "tf2ss", "ss2tf", "zpk2ss", "ss2zpk", "abcd_normalize", "cont2discrete",
    "dlsim", "dstep", "dimpulse", "dfreqresp", "dbode",
    "lsim", "step", "impulse", "freqresp", "bode",
    "__version__",
]
