"""The port's EXR codec (sdirt_tpu_torch/io/exr.py) against the JAX
package's (sdirt_tpu/io/exr.py), bit for bit: files written by either
writer with NONE, ZIPS and ZIP compression, half and float samples, one and
three channels, read by either reader; and the PIZ decoder's two stages,
the canonical-Huffman decode and the 2D wavelet decode, on seeded inputs.
A whole PIZ file is not checked: none is in the repository.
"""

import heapq

import numpy as np
import pytest

from sdirt_tpu.io import exr as JE
from sdirt_tpu_torch.io import exr as TE


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("channels", [1, 3])
def test_read_write_bit_equal(tmp_path, compression, pixel_type, channels):
    rng = np.random.default_rng(channels * 10 + len(compression))
    shape = (37, 53) if channels == 1 else (33, 20, 3)
    img = (rng.random(shape) * 40 - 5).astype(np.float32)
    names = None if channels == 1 else ["R", "G", "B"]
    jp, tp = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    JE.write_exr(jp, img, channel_names=names, pixel_type=pixel_type,
                 compression=compression)
    TE.write_exr(tp, img, channel_names=names, pixel_type=pixel_type,
                 compression=compression)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    ref = JE.read_exr(jp)
    got = TE.read_exr(jp)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    want = img.astype(np.float16).astype(np.float32) if pixel_type == "half" else img
    if channels == 3:
        want = want[..., ::-1]              # cv2's B, G, R order
    np.testing.assert_array_equal(got, want)


def _lengths(freqs):
    """Huffman code lengths of the symbol frequencies."""
    heap = [(f, i, [i]) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    depth = np.zeros(len(freqs), np.int64)
    tie = len(freqs)
    while len(heap) > 1:
        f1, _, s1 = heapq.heappop(heap)
        f2, _, s2 = heapq.heappop(heap)
        depth[s1 + s2] += 1
        heapq.heappush(heap, (f1 + f2, tie, s1 + s2))
        tie += 1
    return depth


def _pack(values_bits):
    """[(value, n_bits)] -> big-endian bitstream bytes and its bit count."""
    acc, n = 0, 0
    for v, b in values_bits:
        acc, n = (acc << b) | v, n + b
    pad = (-n) % 8
    return (acc << pad).to_bytes((n + pad) // 8, "big"), n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_huf_decode_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n_sym = 40 + 30 * seed
    rlc = n_sym                                       # the run-length symbol
    freqs = rng.integers(1, 1000, n_sym + 1)
    table, _ = _pack([(int(v), 6) for v in _lengths(freqs)])
    codes, lengths = TE._huf_unpack_enc_table(TE._BitReader(table), 0, n_sym)
    ref_codes, ref_lengths = JE._huf_unpack_enc_table(JE._BitReader(table), 0, n_sym)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_array_equal(lengths, ref_lengths)

    symbols, stream = [], []
    for _ in range(3000):
        if symbols and rng.random() < 0.05:
            run = int(rng.integers(1, 30))
            stream += [(int(codes[rlc]), int(lengths[rlc])), (run, 8)]
            symbols += [symbols[-1]] * run
        else:
            s = int(rng.integers(0, n_sym))
            stream.append((int(codes[s]), int(lengths[s])))
            symbols.append(s)
    data, n_bits = _pack(stream)
    got = TE._huf_decode(codes, lengths, data, n_bits, rlc, len(symbols))
    ref = JE._huf_decode(ref_codes, ref_lengths, data, n_bits, rlc, len(symbols))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(symbols, np.uint16))


@pytest.mark.parametrize("shape", [(32, 37), (17, 64), (5, 3), (64, 64)])
@pytest.mark.parametrize("mx", [1000, 1 << 15])
def test_wav2_decode_bit_equal(shape, mx):
    rng = np.random.default_rng(shape[0] * shape[1] + mx)
    a = rng.integers(0, mx + 1, shape).astype(np.uint16)
    got, ref = a.copy(), a.copy()
    TE._wav2_decode(got, mx)
    JE._wav2_decode(ref, mx)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, a)
