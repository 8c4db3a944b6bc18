"""Audio/image ops: read-to-tensor + MFCC featurization (port of
``alink_tpu.operator.batch.media``).

Capability parity with the reference's media ops (reference:
core/src/main/java/com/alibaba/alink/operator/batch/audio/
ReadAudioToTensorBatchOp.java, ExtractMfccFeatureBatchOp.java
(common/audio 0.4k LoC), operator/batch/image/ReadImageToTensorBatchOp.java
(common/image 0.3k LoC)).

Re-design: WAV decode via the stdlib ``wave`` module and images via PIL
(imported when an image is read) stay on the host; MFCC is the reference's
FFT → mel filterbank → log → DCT pipeline run on the device in float64,
clips of one frame count batched together (:func:`mfcc_batch`)."""

from __future__ import annotations

import functools
import os
import wave
from typing import List, Sequence

import numpy as np

from ...common.env import resolve_device
from ...common.exceptions import (AkIllegalArgumentException,
                                  AkPluginNotExistException)
from ...common.linalg import DenseVector
from ...common.mtable import AlinkTypes, MTable, TableSchema
from ...common.params import InValidator, MinValidator, ParamInfo
from ...mapper import HasOutputCol, HasReservedCols, HasSelectedCol
from .base import BatchOperator


def read_wav(path: str):
    """(samples float32 in [-1,1] mono, sample_rate)"""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        sr = w.getframerate()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise AkIllegalArgumentException(f"unsupported WAV width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sr


@functools.lru_cache(maxsize=16)
def _cached_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0), hz_to_mel(sr / 2), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(1, n_mels + 1):
        lo, c, hi = bins[i - 1], bins[i], bins[i + 1]
        for j in range(lo, c):
            if c > lo:
                fb[i - 1, j] = (j - lo) / (c - lo)
        for j in range(c, hi):
            if hi > c:
                fb[i - 1, j] = (hi - j) / (hi - c)
    fb.setflags(write=False)
    return fb


def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) triangular filters, float64; built once per
    (sr, n_fft, n_mels) on the host and handed out as a copy."""
    return _cached_filterbank(int(sr), int(n_fft), int(n_mels)).copy()


def _dct_basis(n_mels: int, n_mfcc: int) -> np.ndarray:
    # the reference's basis: the unscaled DCT-II cosine (no orthonormal
    # factors, whatever its comment says)
    k = np.arange(n_mels)
    return np.cos(np.pi / n_mels * (k[:, None] + 0.5)
                  * np.arange(n_mfcc)[None, :])


# host bytes of one chunk's float64 frames: bounds the card's working set
# (frames, spectrum, mel energies) to about 1 GB a chunk
_CHUNK_FRAME_BYTES = 1 << 28


def mfcc_batch(clips: Sequence[np.ndarray], sr: int, n_mfcc: int = 13,
               n_fft: int = 512, hop: int = 256, n_mels: int = 26,
               device=None, pool: bool = False) -> List[np.ndarray]:
    """MFCCs of many clips on the device, float64 end to end as the
    reference's numpy path: each clip's (frames, n_mfcc) matrix, or its
    mean over the frames with ``pool``. Clips that share a frame count run
    as one batch (in chunks of about 256 MB of frames): frames by
    ``unfold``, the symmetric Hann window, ``rfft``, |.|², the filterbank
    product, ``log(. + 1e-10)`` and the DCT-II basis."""
    import torch

    dev = resolve_device(device)
    fbT = torch.as_tensor(_cached_filterbank(int(sr), int(n_fft),
                                             int(n_mels)).T.copy(),
                          device=dev)
    basis = torch.as_tensor(_dct_basis(n_mels, n_mfcc), device=dev)
    window = torch.hann_window(n_fft, periodic=False, dtype=torch.float64,
                               device=dev)
    # clips shorter than n_fft are zero-padded to n_fft; a clip of n
    # samples has (n - n_fft) // hop + 1 frames
    groups = {}
    for i, x in enumerate(clips):
        n = max(int(np.asarray(x).size), n_fft)
        groups.setdefault((n - n_fft) // hop + 1, []).append(i)
    out: List[np.ndarray] = [None] * len(clips)
    for frames, idx in groups.items():
        used = (frames - 1) * hop + n_fft
        step = max(1, _CHUNK_FRAME_BYTES // (frames * n_fft * 8))
        for s in range(0, len(idx), step):
            part = idx[s:s + step]
            block = np.zeros((len(part), used))
            for r, i in enumerate(part):
                x = np.asarray(clips[i], np.float64).reshape(-1)[:used]
                block[r, :x.size] = x
            x = torch.from_numpy(block).to(dev)
            F = x.unfold(1, n_fft, hop) * window        # (b, t, n_fft)
            spec = torch.fft.rfft(F, dim=-1).abs() ** 2
            m = torch.log(spec @ fbT + 1e-10) @ basis   # (b, t, n_mfcc)
            if pool:
                m = m.mean(dim=1)
            m = m.cpu().numpy()
            for r, i in enumerate(part):
                out[i] = m[r]
    return out


def mfcc(samples: np.ndarray, sr: int, n_mfcc: int = 13, n_fft: int = 512,
         hop: int = 256, n_mels: int = 26, device=None) -> np.ndarray:
    """(frames, n_mfcc) MFCC matrix — FFT → mel energies → log → DCT-II
    (reference: common/audio MFCC extraction), one clip through
    :func:`mfcc_batch`."""
    return mfcc_batch([samples], sr, n_mfcc, n_fft, hop, n_mels,
                      device=device)[0]


class ReadAudioToTensorBatchOp(BatchOperator, HasSelectedCol, HasOutputCol,
                               HasReservedCols):
    """WAV file column → waveform vector (reference:
    ReadAudioToTensorBatchOp.java)."""

    ROOT_FILE_PATH = ParamInfo("rootFilePath", str, default="")
    SAMPLE_RATE_COL = ParamInfo("sampleRateCol", str)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        root = self.get(self.ROOT_FILE_PATH)
        out = self.get(HasOutputCol.OUTPUT_COL) or "audio"
        vecs, srs = [], []
        for rel in t.col(self.get(HasSelectedCol.SELECTED_COL)):
            data, sr = read_wav(os.path.join(root, str(rel)))
            vecs.append(DenseVector(data))
            srs.append(sr)
        res = t.with_column(out, np.asarray(vecs, object),
                            AlinkTypes.DENSE_VECTOR)
        sr_col = self.get(self.SAMPLE_RATE_COL)
        if sr_col:
            res = res.with_column(sr_col, np.asarray(srs, np.int64),
                                  AlinkTypes.LONG)
        return res

    def _out_schema(self, in_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "audio"
        names = list(in_schema.names) + [out]
        types = list(in_schema.types) + [AlinkTypes.DENSE_VECTOR]
        sr_col = self.get(self.SAMPLE_RATE_COL)
        if sr_col:
            names.append(sr_col)
            types.append(AlinkTypes.LONG)
        return TableSchema(names, types)


class ExtractMfccFeatureBatchOp(BatchOperator, HasSelectedCol, HasOutputCol,
                                HasReservedCols):
    """Waveform vector column → MFCC features. Default emits the FULL
    (frames x coeffs) tensor — the time axis downstream DL consumes
    (reference: ExtractMfccFeatureBatchOp.java emits the frame tensor);
    ``poolingMode=MEAN`` keeps the old mean-pooled vector."""

    SAMPLE_RATE = ParamInfo("sampleRate", int, default=16000)
    N_MFCC = ParamInfo("nMfcc", int, default=13, validator=MinValidator(2))
    POOLING_MODE = ParamInfo("poolingMode", str, default="NONE",
                             validator=InValidator("NONE", "MEAN"))

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        from ...common.linalg import parse_vector

        out = self.get(HasOutputCol.OUTPUT_COL) or "mfcc"
        sr = self.get(self.SAMPLE_RATE)
        n_mfcc = self.get(self.N_MFCC)
        pool = self.get(self.POOLING_MODE) == "MEAN"
        clips = [parse_vector(v).to_dense().data
                 for v in t.col(self.get(HasSelectedCol.SELECTED_COL))]
        mats = mfcc_batch(clips, sr, n_mfcc=n_mfcc, device=self.env.device,
                          pool=pool)
        cells = [DenseVector(m) if pool else np.asarray(m, np.float32)
                 for m in mats]
        # element-wise fill: np.asarray(list_of_2d_arrays, object) would
        # broadcast equal-shaped tensors into one big object ndarray
        col = np.empty(len(cells), object)
        for i, cell in enumerate(cells):
            col[i] = cell
        return t.with_column(out, col, self._out_type())

    def _out_type(self):
        return (AlinkTypes.DENSE_VECTOR
                if self.get(self.POOLING_MODE) == "MEAN"
                else AlinkTypes.TENSOR)

    def _out_schema(self, in_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "mfcc"
        return TableSchema(list(in_schema.names) + [out],
                           list(in_schema.types) + [self._out_type()])


class ReadImageToTensorBatchOp(BatchOperator, HasSelectedCol, HasOutputCol,
                               HasReservedCols):
    """Image file column → flattened float vector (H·W·C in [0,1]) with
    optional resize (reference: ReadImageToTensorBatchOp.java)."""

    ROOT_FILE_PATH = ParamInfo("rootFilePath", str, default="")
    IMAGE_WIDTH = ParamInfo("imageWidth", int)
    IMAGE_HEIGHT = ParamInfo("imageHeight", int)

    _min_inputs = 1
    _max_inputs = 1

    def _execute_impl(self, t: MTable) -> MTable:
        try:
            from PIL import Image
        except ImportError as e:
            raise AkPluginNotExistException(
                "ReadImageToTensorBatchOp needs the 'Pillow' package (PIL) "
                "to decode and resize images, which the port does not "
                "depend on") from e

        root = self.get(self.ROOT_FILE_PATH)
        out = self.get(HasOutputCol.OUTPUT_COL) or "tensor"
        w = self.get(self.IMAGE_WIDTH)
        h = self.get(self.IMAGE_HEIGHT)
        vecs = []
        for rel in t.col(self.get(HasSelectedCol.SELECTED_COL)):
            img = Image.open(os.path.join(root, str(rel))).convert("RGB")
            if w and h:
                img = img.resize((int(w), int(h)))
            arr = np.asarray(img, np.float32) / 255.0
            vecs.append(DenseVector(arr.ravel()))
        return t.with_column(out, np.asarray(vecs, object),
                             AlinkTypes.DENSE_VECTOR)

    def _out_schema(self, in_schema):
        out = self.get(HasOutputCol.OUTPUT_COL) or "tensor"
        return TableSchema(list(in_schema.names) + [out],
                           list(in_schema.types) + [AlinkTypes.DENSE_VECTOR])
