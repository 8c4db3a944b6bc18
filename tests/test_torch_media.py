"""Parity of the port's media ops (``alink_tpu_torch.operator.batch.media``)
with the reference's on the CPU: ``read_wav`` at sample widths 1, 2 and 4,
mono and stereo (equal arrays); the mel filterbank (equal); MFCC through
``ExtractMfccFeatureBatchOp`` in both pooling modes, short clips among the
inputs (float32 frames within 1e-6 of the largest |coefficient|, pooled
float64 vectors within 1e-9); ``ReadImageToTensorBatchOp`` against the
reference where Pillow is present, and its missing-plugin gate."""

import os
import wave

import numpy as np
import pytest

SR = 16000


@pytest.fixture
def cpu_device(monkeypatch):
    monkeypatch.setenv("ALINK_TORCH_DEVICE", "cpu")


def _write_wav(path, samples, width, channels):
    """``samples`` in [-1, 1), shape (n, channels), as a PCM WAV file."""
    if width == 1:
        raw = np.clip(samples * 128 + 128, 0, 255).astype(np.uint8)
    elif width == 2:
        raw = np.clip(samples * 32768, -32768, 32767).astype("<i2")
    else:
        raw = np.clip(samples * 2 ** 31, -2 ** 31, 2 ** 31 - 1).astype("<i4")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(SR)
        w.writeframes(raw.tobytes())


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_matches_the_reference(tmp_path, width, channels):
    from alink_tpu.operator.batch.media import read_wav as ref_read
    from alink_tpu_torch.operator.batch.media import read_wav

    rng = np.random.default_rng(width * 10 + channels)
    path = str(tmp_path / "a.wav")
    _write_wav(path, rng.uniform(-0.9, 0.9, (1234, channels)), width,
               channels)
    (got, sr), (want, ref_sr) = read_wav(path), ref_read(path)
    assert sr == ref_sr == SR
    assert got.dtype == want.dtype and got.shape == want.shape == (1234,)
    np.testing.assert_array_equal(got, want)


def test_read_wav_rejects_other_widths(tmp_path):
    from alink_tpu_torch.common.exceptions import AkIllegalArgumentException
    from alink_tpu_torch.operator.batch.media import read_wav

    path = str(tmp_path / "a.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(SR)
        w.writeframes(b"\0" * 30)
    with pytest.raises(AkIllegalArgumentException):
        read_wav(path)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 512, 26),
                                             (8000, 256, 40),
                                             (22050, 1024, 64)])
def test_filterbank_is_the_references(sr, n_fft, n_mels):
    from alink_tpu.operator.batch.media import _mel_filterbank as ref_fb
    from alink_tpu_torch.operator.batch.media import _mel_filterbank

    got = _mel_filterbank(sr, n_fft, n_mels)
    np.testing.assert_array_equal(got, ref_fb(sr, n_fft, n_mels))
    got[0, 0] = 7.0       # a copy: the cached bank is untouched
    assert _mel_filterbank(sr, n_fft, n_mels)[0, 0] != 7.0


def _clips(seed=0):
    """Tones with noise, one-second and odd lengths, two shorter than
    n_fft (512) and one exactly n_fft."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (SR, SR, 9000, 700, 300, 512, 100, SR + 37):
        t = np.arange(n) / SR
        f = rng.uniform(100, 3000)
        out.append((0.5 * np.sin(2 * np.pi * f * t)
                    + 0.05 * rng.normal(size=n)).astype(np.float32))
    return out


def _mfcc_tables(pool, clips):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.linalg import DenseVector as RV
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.linalg import DenseVector as PV
    from alink_tpu_torch.common.mtable import MTable as PT

    out = []
    for ops, T, V in ((R, RT, RV), (P, PT, PV)):
        col = np.empty(len(clips), object)
        col[:] = [V(c) for c in clips]
        t = T({"audio": col}, "audio DENSE_VECTOR")
        out.append(ops.ExtractMfccFeatureBatchOp(
            selectedCol="audio", poolingMode=pool).link_from(
            ops.TableSourceBatchOp(t)).collect())
    return out


@pytest.mark.usefixtures("cpu_device")
def test_mfcc_frames_match_the_reference():
    ref, port = _mfcc_tables("NONE", _clips())
    assert port.schema.to_str() == ref.schema.to_str()
    for a, b in zip(port.col("mfcc"), ref.col("mfcc")):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())
    # frame counts: (n - n_fft) // hop + 1, short clips padded to n_fft
    assert [m.shape[0] for m in port.col("mfcc")] == [61, 61, 34, 1, 1, 1,
                                                      1, 61]


@pytest.mark.usefixtures("cpu_device")
def test_mfcc_mean_pooling_matches_the_reference():
    ref, port = _mfcc_tables("MEAN", _clips(1))
    for a, b in zip(port.col("mfcc"), ref.col("mfcc")):
        assert type(a).__name__ == "DenseVector"
        np.testing.assert_allclose(a.data, b.data, rtol=0,
                                   atol=1e-9 * np.abs(b.data).max())


@pytest.mark.usefixtures("cpu_device")
def test_mfcc_batch_equals_one_clip_at_a_time():
    """Chunking and grouping by frame count do not change a clip's
    coefficients (float64, against the per-clip call)."""
    from alink_tpu_torch.operator.batch import media

    clips = _clips(2)
    whole = media.mfcc_batch(clips, SR, device="cpu")
    for c, m in zip(clips, whole):
        np.testing.assert_allclose(m, media.mfcc(c, SR, device="cpu"),
                                   rtol=1e-13, atol=1e-12)


def test_a_periodic_window_fails_the_comparison(monkeypatch):
    """``np.hanning`` is the symmetric window: the same pipeline with
    torch's periodic default parts from the reference far beyond the
    test's 1e-6."""
    import torch

    from alink_tpu.operator.batch.media import mfcc as ref_mfcc
    from alink_tpu_torch.operator.batch import media

    clip = _clips(3)[0]
    want = ref_mfcc(clip.astype(np.float64), SR)
    sym = media.mfcc(clip, SR, device="cpu")
    assert np.abs(sym - want).max() <= 1e-6 * np.abs(want).max()
    real = torch.hann_window
    monkeypatch.setattr(torch, "hann_window", lambda n, periodic=True, **kw:
                        real(n, periodic=True, **kw))
    per = media.mfcc(clip, SR, device="cpu")
    assert np.abs(per - want).max() > 1e-4 * np.abs(want).max()


@pytest.mark.usefixtures("cpu_device")
def test_read_audio_op_matches_the_reference(tmp_path):
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    rng = np.random.default_rng(4)
    names = []
    for i, (width, ch) in enumerate([(1, 1), (2, 2), (4, 1), (2, 1)]):
        names.append(f"c{i}.wav")
        _write_wav(str(tmp_path / names[-1]),
                   rng.uniform(-0.5, 0.5, (800 + i, ch)), width, ch)
    out = []
    for ops, T in ((R, RT), (P, PT)):
        t = T({"f": np.asarray(names, object)})
        out.append(ops.ReadAudioToTensorBatchOp(
            selectedCol="f", rootFilePath=str(tmp_path),
            sampleRateCol="sr").link_from(ops.TableSourceBatchOp(t))
            .collect())
    ref, port = out
    assert port.schema.to_str() == ref.schema.to_str()
    assert list(port.col("sr")) == list(ref.col("sr"))
    for a, b in zip(port.col("audio"), ref.col("audio")):
        np.testing.assert_array_equal(a.data, b.data)


def _images(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(6)
    names = []
    for i, (h, w) in enumerate([(5, 7), (9, 4)]):
        names.append(f"i{i}.png")
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
                        ).save(str(tmp_path / names[-1]))
    return names


@pytest.mark.usefixtures("cpu_device")
def test_read_image_matches_the_reference(tmp_path):
    pytest.importorskip("PIL")
    import alink_tpu.operator.batch as R
    import alink_tpu_torch.operator.batch as P
    from alink_tpu.common.mtable import MTable as RT
    from alink_tpu_torch.common.mtable import MTable as PT

    names = _images(tmp_path)
    for size in ({}, dict(imageWidth=3, imageHeight=6)):
        out = []
        for ops, T in ((R, RT), (P, PT)):
            t = T({"f": np.asarray(names, object)})
            out.append(ops.ReadImageToTensorBatchOp(
                selectedCol="f", rootFilePath=str(tmp_path), **size)
                .link_from(ops.TableSourceBatchOp(t)).collect())
        ref, port = out
        for a, b in zip(port.col("tensor"), ref.col("tensor")):
            np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.usefixtures("cpu_device")
def test_read_image_without_pillow_names_it(tmp_path, monkeypatch):
    import builtins

    import alink_tpu_torch.operator.batch as P
    from alink_tpu_torch.common.exceptions import AkPluginNotExistException
    from alink_tpu_torch.common.mtable import MTable

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    t = MTable({"f": np.asarray(["x.png"], object)})
    with pytest.raises(AkPluginNotExistException, match="Pillow"):
        P.ReadImageToTensorBatchOp(selectedCol="f", rootFilePath=os.fspath(
            tmp_path)).link_from(P.TableSourceBatchOp(t)).collect()
