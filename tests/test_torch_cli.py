"""neojax_torch.cli against neojax.cli on the CPU (``--device cpu``): the same
WAV files through both CLIs (``tests/test_cli.py``'s fixture), each
engine's output against the ``np.convolve`` oracle within 1e-3 after peak
scaling, and against ``neojax.cli.main``'s output file within 1e-5 at the
CPU's default storages (dense for upols/upola, split for the throughput
engines) or the storage's tolerance (``_TOL``, max|a - b| / max|b|); the
perceptual threshold, a resampled impulse, the channel-mismatch exit code
2, the chunked → nested route for a per-channel IR, and the 16-bit output.
"""

import subprocess
import sys

import numpy as np
import pytest

from neojax.cli import main as jax_main
from neojax_torch.cli import main as torch_main
from neojax_torch import conv as tconv
from neojax_torch.io.resample import resample
from neojax_torch.io.wav import read_wav, write_wav

SR = 8000
_TOL = {"split": 2e-5, "bf16": 5e-3, "int16": 5e-4, "int8": 2e-2}
_ENGINES = ["upols", "upola", "chunked", "nested", "hybrid"]


@pytest.fixture()
def wavs(tmp_path):
    rng = np.random.default_rng(0)
    sig = rng.uniform(-0.9, 0.9, (2, 4 * 1024)).astype(np.float32)
    t = np.arange(2048) / SR
    ir = (rng.standard_normal((2, t.size)) * np.exp(-t / 0.05)[None]).astype(np.float32)
    ir /= np.abs(ir).max()  # PCM files clip outside full scale
    sp, ip, mp = (str(tmp_path / n) for n in ("sig.wav", "ir.wav", "mono.wav"))
    write_wav(sp, sig, SR, bits=32)
    write_wav(ip, ir, SR, bits=32)
    write_wav(mp, ir[:1], SR, bits=32)
    return sp, ip, mp, str(tmp_path), sig, ir


def _oracle(sig, ir):
    irn = tconv.normalize_impulse(ir).numpy()
    irn = np.broadcast_to(irn, (sig.shape[0], irn.shape[-1]))
    return np.stack([np.convolve(sig[i], irn[i])[: sig.shape[1]] for i in range(sig.shape[0])])


def _both(sp, ip, out_dir, *opts):
    """Run both CLIs on the same files; return (port's, neojax's) output."""
    tp, jp = f"{out_dir}/torch.wav", f"{out_dir}/jax.wav"
    assert torch_main([sp, ip, tp, *opts, "--device", "cpu"]) == 0
    assert jax_main([sp, ip, jp, *opts]) == 0
    (t, tsr), (j, jsr) = read_wav(tp), read_wav(jp)
    assert tsr == jsr
    return t, j


@pytest.mark.parametrize("engine", _ENGINES)
@pytest.mark.parametrize("impulse", ["stereo", "mono"])
def test_cli_engines_match_neojax_and_direct_convolution(wavs, engine, impulse):
    sp, ip, mp, out_dir, sig, ir = wavs
    ir_path, ir_used = (ip, ir) if impulse == "stereo" else (mp, ir[:1])
    t, j = _both(sp, ir_path, out_dir, "--block", "256", "--engine", engine, "--chunk-blocks", "4", "--bits", "32")
    assert t.shape == sig.shape
    assert np.abs(t - j).max() < 1e-5
    ref = _oracle(sig, ir_used)
    # the CLI peak-normalizes outputs above full scale; compare shapes
    err = np.abs(t / np.abs(t).max() - ref / np.abs(ref).max()).max()
    assert err < 1e-3, f"{engine}: max err {err:.2e}"


@pytest.mark.parametrize("engine,storage", [("upols", "split"), ("upols", "int16"), ("upola", "int8"),
                                            ("nested", "bf16"), ("hybrid", "int16"), ("chunked", "bf16")])
def test_cli_storages_match_neojax(wavs, engine, storage):
    sp, _, mp, out_dir, _, _ = wavs
    t, j = _both(sp, mp, out_dir, "--block", "128", "--engine", engine, "--chunk-blocks", "4",
                 "--storage", storage, "--bits", "32")
    assert np.abs(t - j).max() / np.abs(j).max() < _TOL[storage]


@pytest.mark.parametrize("engine", ["upols", "nested"])
def test_cli_threshold_sparsifies_like_neojax(wavs, capsys, engine):
    sp, ip, _, out_dir, _, _ = wavs
    t, j = _both(sp, ip, out_dir, "--block", "256", "--engine", engine, "--chunk-blocks", "4",
                 "--threshold-db", "-40", "--bits", "32")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("perceptual mask")]
    assert len(lines) == 2 and lines[0] == lines[1]  # the same density from both
    assert np.abs(t).max() > 1e-3 and np.abs(t - j).max() < 1e-5


def test_cli_resamples_mismatched_impulse(tmp_path):
    rng = np.random.default_rng(3)
    sr, ir_sr = 16000, 8000
    sig = rng.uniform(-1, 1, (1, sr)).astype(np.float32)
    ir = np.zeros((1, 400), np.float32)
    ir[0, 0] = 1.0  # an identity impulse at 8 kHz stays ~identity at 16 kHz
    sp, ip = str(tmp_path / "s.wav"), str(tmp_path / "i.wav")
    write_wav(sp, sig, sr, bits=32)
    write_wav(ip, ir, ir_sr, bits=32)
    t, j = _both(sp, ip, str(tmp_path), "--block", "512", "--bits", "32")
    assert np.abs(t - j).max() < 1e-5
    want = _oracle(sig, resample(ir, ir_sr, sr))[0]
    assert np.abs(t[0] - want / np.abs(want).max()).max() < 5e-3


def test_cli_channel_mismatch_errors(tmp_path, wavs):
    sp, _, _, out_dir, _, _ = wavs
    bad = str(tmp_path / "bad.wav")
    write_wav(bad, np.zeros((3, 1024), np.float32), SR, bits=32)
    assert torch_main([sp, bad, f"{out_dir}/o.wav", "--block", "256", "--device", "cpu"]) == 2
    assert jax_main([sp, bad, f"{out_dir}/o.wav", "--block", "256"]) == 2


def test_cli_chunked_routes_a_per_channel_impulse_to_nested(wavs, capsys):
    sp, ip, _, out_dir, _, _ = wavs
    t, j = _both(sp, ip, out_dir, "--block", "256", "--engine", "chunked", "--chunk-blocks", "4", "--bits", "32")
    out = capsys.readouterr().out
    assert out.count("chunked is shared-IR only; using nested for the 2-channel IR") == 2
    n, _ = _both(sp, ip, out_dir, "--block", "256", "--engine", "nested", "--chunk-blocks", "4", "--bits", "32")
    np.testing.assert_array_equal(t, n)


def test_cli_16_bit_output_and_report(wavs, capsys):
    sp, _, mp, out_dir, sig, _ = wavs
    tp, jp = f"{out_dir}/t16.wav", f"{out_dir}/j16.wav"
    assert torch_main([sp, mp, tp, "--block", "256", "--engine", "nested", "--chunk-blocks", "4",
                       "--device", "cpu"]) == 0
    report = capsys.readouterr().out
    assert "real-time factor" in report and "M samples/s" in report and f"wrote {tp}" in report
    assert jax_main([sp, mp, jp, "--block", "256", "--engine", "nested", "--chunk-blocks", "4"]) == 0
    t, j = read_wav(tp)[0], read_wav(jp)[0]
    assert t.shape == sig.shape and np.abs(t - j).max() <= 1.0 / 32767 + 1e-7  # one 16-bit step


def test_cli_runs_as_a_module(wavs):
    sp, _, mp, out_dir, _, _ = wavs
    res = subprocess.run([sys.executable, "-m", "neojax_torch.cli", sp, mp, f"{out_dir}/m.wav", "--block", "512",
                          "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "real-time factor" in res.stdout
    help_text = subprocess.run([sys.executable, "-m", "neojax_torch.cli", "--help"], capture_output=True,
                               text=True, timeout=300).stdout
    assert "--device" in help_text and "--threshold-db" in help_text
