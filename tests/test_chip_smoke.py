"""chip_smoke.py at tiny sizes on the CPU: every phase function against its
reference, the refusal to run without a GPU, and the multi-device dry run's
choice between real devices and virtual CPU devices.  The full-size run
needs the card (``-m gpu``)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as graft
import chip_smoke as cs
from mixed_radix_fast_fourier_transform_tpu.parallel import make_mesh


def _check(recs, count):
    assert len(recs) == count
    for r in recs:
        assert r["ok"], r
        times = [r[k] for k in ("lower_s", "compile_s", "step_s") if k in r]
        assert times and min(times) >= 0.0
        assert "precision" in r and r["tol"] >= 0.0


@pytest.mark.parametrize("n, batch", [(64, 4), (360, 3), (1024, 2)])
def test_c2c_phase(n, batch):
    _check(cs.phase_c2c(np.random.default_rng(0), n, batch), 2)


@pytest.mark.parametrize("n", [127, 1009])
def test_bluestein_phase(n):
    _check(cs.phase_bluestein(np.random.default_rng(1), n, 3), 1)


@pytest.mark.parametrize("n", [64, 360])
def test_real_phase(n):
    _check(cs.phase_real(np.random.default_rng(2), n, 4), 2)


def test_convolve_phase():
    recs = cs.phase_convolve(np.random.default_rng(3), 200, 17, 3)
    _check(recs, 3)
    assert [r["phase"].split("_")[2] for r in recs] == ["full", "same", "valid"]


def test_fnet_phase_matches_fft2_mixing():
    recs = cs.phase_fnet(jax.random.PRNGKey(0), hidden=24, ff_dim=48,
                         n_layers=2, seq=16, batch=2)
    _check(recs, 3)
    assert len(recs[2]["losses"]) == 3
    assert recs[0]["loss"] == pytest.approx(recs[0]["loss_ref"], rel=1e-5)


def test_cufft_reference_is_the_fnet_model():
    from mixed_radix_fast_fourier_transform_tpu.models import fnet

    x = jax.random.normal(jax.random.PRNGKey(4), (2, 12, 20), jnp.float32)
    t = jax.random.normal(jax.random.PRNGKey(6), (2, 12, 20), jnp.float32)
    np.testing.assert_allclose(np.asarray(fnet.fourier_mix(x)),
                               np.asarray(cs.cufft_mix(x)), atol=2e-5)
    params = fnet.init_fnet(jax.random.PRNGKey(5), 20, 40, 2)
    assert float(cs.cufft_fnet_loss(params, x, t)) == pytest.approx(
        float(fnet.loss_fn(params, x, t)), rel=1e-5)


def test_four_step_phase_on_virtual_devices():
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    _check(cs.phase_four_step(mesh, 1024, 2, seed=0), 1)


def test_sharded_convolve_phase_on_virtual_devices():
    mesh = make_mesh((1, 4), devices=jax.devices()[:4])
    _check(cs.phase_sharded_convolve(mesh, 1024, 17, 4, seed=0), 1)


def test_distributed_filter_phase_on_virtual_devices():
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    recs = cs.phase_distributed_filter(mesh, 8, 4, seed=0)
    _check(recs, 3)
    assert [r["phase"].rsplit("_", 1)[1] for r in recs] == [
        "loss", "grad", "update"]


@pytest.mark.parametrize("spoil", ["grads", "new_params"])
def test_distributed_filter_phase_sees_a_wrong_backward(spoil, monkeypatch):
    """A gradient or update off by 1 % (a dropped or scaled shard of the
    reverse exchange) fails its check even though the loss still agrees."""
    real = graft.distributed_filter_step

    def spoiled(*a, **kw):
        out = real(*a, **kw)
        if spoil == "grads":
            out[spoil] = jax.tree_util.tree_map(lambda g: 1.01 * g,
                                                out[spoil])
        else:
            out[spoil] = dict(out[spoil],
                              gain_re=out[spoil]["gain_re"] + 1e-2)
        return out

    monkeypatch.setattr(graft, "distributed_filter_step", spoiled)
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    loss, grad, update = cs.phase_distributed_filter(mesh, 8, 4, seed=0)
    assert loss["ok"]
    assert not (grad["ok"] if spoil == "grads" else update["ok"])


def test_hermitian_gain_reproduces_complex_filter():
    n = 16
    rng = np.random.default_rng(6)
    g = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = rng.standard_normal((3, n))
    h = cs.hermitian_gain({"gain_re": g.real, "gain_im": g.imag,
                           "bias": 0.0}, n)
    hc = np.asarray(h["gain_re"]) + 1j * np.asarray(h["gain_im"])
    want = np.real(np.fft.ifft(np.fft.fft(x) * g))
    got = np.fft.irfft(np.fft.rfft(x) * hc, n=n)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_relerr_is_relative_to_reference_max():
    assert cs.relerr([1.0, 2.0], [1.0, 4.0]) == pytest.approx(0.5)
    assert cs.device_relerr(jnp.ones(3), 2 * jnp.ones(3)) == pytest.approx(0.5)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as ei:
        cs.main(argv)
    assert ei.value.code != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_run_phases_counts_failures_and_exceptions(capsys):
    def bad():
        raise RuntimeError("compile refused")

    failed = cs.run_phases([
        ("good", lambda: [cs.record("a", 1e-7, 1e-5, {"compile_s": 0.1})]),
        ("over", lambda: [cs.record("b", 1e-3, 1e-5, {"compile_s": 0.1})]),
        ("raises", bad),
    ])
    assert failed == 2
    out = capsys.readouterr().out
    assert "compile refused" in out and '"ok": true' in out


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    rng = np.random.default_rng(0)
    _check(cs.phase_c2c(rng, 1024, 256), 2)
    _check(cs.phase_bluestein(rng, 10007, 16), 1)
    _check(cs.phase_fnet(jax.random.PRNGKey(0), hidden=96, ff_dim=384,
                         n_layers=2, seq=64, batch=2), 3)


# ---------------------------------------------------------------------------
# __graft_entry__.dryrun_multichip: real devices over the CPU subprocess
# ---------------------------------------------------------------------------

def _fake_devices(platform, count):
    return [types.SimpleNamespace(platform=platform, id=i)
            for i in range(count)]


@pytest.fixture
def dryrun_spies(monkeypatch):
    calls = {"impl": [], "subprocess": []}
    monkeypatch.setattr(graft, "_dryrun_multichip_impl",
                        lambda n: calls["impl"].append(n))

    def fake_run(cmd, **kw):
        calls["subprocess"].append(kw["env"])
        return types.SimpleNamespace(returncode=0, stdout=b"DRYRUN_OK\n")

    monkeypatch.setattr(graft.subprocess, "run", fake_run)
    return calls


@pytest.mark.parametrize("platform, count", [("gpu", 4), ("gpu", 8),
                                             ("cpu", 8)])
def test_dryrun_runs_in_process_when_devices_suffice(
        platform, count, dryrun_spies, monkeypatch):
    monkeypatch.setattr(graft.jax, "devices",
                        lambda: _fake_devices(platform, count))
    graft.dryrun_multichip(4)
    assert dryrun_spies["impl"] == [4]
    assert dryrun_spies["subprocess"] == []


def test_dryrun_too_few_gpus_raises(dryrun_spies, monkeypatch):
    monkeypatch.setattr(graft.jax, "devices", lambda: _fake_devices("gpu", 1))
    with pytest.raises(RuntimeError, match="needs 4 gpu devices"):
        graft.dryrun_multichip(4)
    assert dryrun_spies["impl"] == [] and dryrun_spies["subprocess"] == []


def test_dryrun_cpu_with_too_few_devices_uses_virtual_devices(
        dryrun_spies, monkeypatch):
    monkeypatch.setattr(graft.jax, "devices", lambda: _fake_devices("cpu", 1))
    graft.dryrun_multichip(4)
    assert dryrun_spies["impl"] == []
    (env,) = dryrun_spies["subprocess"]
    assert env["JAX_PLATFORMS"] == "cpu"
    assert "device_count=4" in env["XLA_FLAGS"]
