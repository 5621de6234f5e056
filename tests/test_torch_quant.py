"""The quantised sync wire of the port (``metrics_tpu_torch/quant.py``)
held against ``metrics_tpu/quant.py``: the same numpy inputs give the same
codes, scales, packed planes and payload bytes (bit-equal), and the error
bounds of ``metrics_tpu/quant.py:29-47`` hold."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrics_tpu import quant as jq
from metrics_tpu_torch import quant as tq


def _inputs(seed, n, scale=10.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * scale).astype(np.float32)
    if n > 8:
        # halves on the code lattice of their block (round half to even), zeros and a zero block
        x[:4] = np.float32(0.0)
        x[5] = np.float32(2.5)
        x[6] = np.float32(-3.5)
    return x


@pytest.mark.parametrize("rounding", ["nearest", "up"])
@pytest.mark.parametrize("block", [8, 32, 256, 1024])
@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4099])
def test_q8_codes_and_scales_bit_equal_to_jax(n, block, rounding):
    x = _inputs(n + block, n)
    jcodes, jscale = jq.encode_q8(jnp.asarray(x), block=block, rounding=rounding)
    tcodes, tscale = tq.encode_q8(torch.from_numpy(x), block=block, rounding=rounding)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tscale.numpy().view(np.uint32), np.asarray(jscale).view(np.uint32))
    jdec = np.asarray(jq.decode_q8(jcodes, jscale, n))
    tdec = tq.decode_q8(tcodes, tscale, n).numpy()
    np.testing.assert_array_equal(tdec.view(np.uint32), jdec.view(np.uint32))


def test_q8_rounds_half_to_even_as_jax():
    # one block whose amax is 127: every code is x itself, so the .5s show the tie rule
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], dtype=np.float32)
    codes, scale = tq.encode_q8(torch.from_numpy(x), block=8)
    assert float(scale[0]) == 1.0
    assert codes.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jq.encode_q8(jnp.asarray(x), block=8)[0]))


@pytest.mark.parametrize("bits", [1, 2, 5, 8])
@pytest.mark.parametrize("n", [1, 7, 8, 1000, 16384])
def test_pack_bits_bit_equal_to_jax_and_lossless(bits, n):
    x = np.random.RandomState(bits * n).randint(0, 1 << bits, size=n).astype(np.int32)
    jp = np.asarray(jq.pack_bits(jnp.asarray(x), bits))
    tp = tq.pack_bits(torch.from_numpy(x), bits)
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), jp)
    back = tq.unpack_bits(tp, bits, n)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jq.unpack_bits(jnp.asarray(jp), bits, n)))


@pytest.mark.parametrize(
    "codec",
    [tq.QuantCodec("q8"), tq.QuantCodec("q8", rounding="up"), tq.QuantCodec("pack", bits=5)],
    ids=["q8", "q8u", "pack5"],
)
@pytest.mark.parametrize("n", [3, 256, 2048, 5000])
def test_bucket_payload_bytes_equal_to_jax(codec, n):
    jcodec = jq.QuantCodec(codec.kind, codec.bits, codec.rounding)
    if codec.kind == "pack":
        buf = np.random.RandomState(n).randint(0, 20, size=n).astype(np.int32)
    else:
        buf = _inputs(n, n)
    jpay = np.asarray(jq.encode_bucket(jnp.asarray(buf), jcodec))
    tpay = tq.encode_bucket(torch.from_numpy(buf), codec)
    assert tpay.dtype == torch.uint8
    assert tpay.numel() == tq.bucket_wire_nbytes(n, codec) == jq.bucket_wire_nbytes(n, jcodec)
    np.testing.assert_array_equal(tpay.numpy(), jpay)
    jdec = np.asarray(jq.decode_bucket(jnp.asarray(jpay), jcodec, n))
    tdec = tq.decode_bucket(tpay, codec, n).numpy()
    assert tdec.dtype == jdec.dtype
    np.testing.assert_array_equal(tdec.view(np.uint8), jdec.view(np.uint8))


@pytest.mark.parametrize("rounding", ["nearest", "up"])
def test_numpy_twin_bit_equal_to_jax_twin_and_tensor_codec(rounding):
    x = _inputs(7, 3000)
    jq_b, js_b = jq.np_encode_q8(x, block=128, rounding=rounding)
    tq_b, ts_b = tq.np_encode_q8(x, block=128, rounding=rounding)
    assert (tq_b, ts_b) == (jq_b, js_b)
    codes, scale = tq.encode_q8(torch.from_numpy(x), block=128, rounding=rounding)
    assert codes.numpy().tobytes() == tq_b and scale.numpy().tobytes() == ts_b
    np.testing.assert_array_equal(tq.np_decode_q8(tq_b, ts_b, 3000, block=128),
                                  jq.np_decode_q8(jq_b, js_b, 3000, block=128))


@pytest.mark.parametrize("block", [8, 32, 256, 1024])
def test_q8_error_within_documented_bound(block):
    """|decode(encode(x)) - x| <= amax_block / 254 with nearest rounding."""
    x = _inputs(block, block * 7 + 3)
    codes, scale = tq.encode_q8(torch.from_numpy(x), block=block)
    dec = tq.decode_q8(codes, scale, x.size).numpy()
    pad = np.pad(x, (0, codes.numel() - x.size))
    amax = np.abs(pad.reshape(-1, block)).max(axis=1)
    bound = np.repeat(amax * tq.REL_ERROR_BOUND, block)[: x.size]
    assert np.all(np.abs(dec - x) <= bound * (1 + 1e-6))


def test_q8_up_rounding_never_underestimates_counts():
    """``x <= decoded <= x + amax_block / 126`` on integer counts (the
    count-min table's case), per element."""
    rng = np.random.RandomState(3)
    x = rng.zipf(1.3, size=4096).clip(max=10_000_000).astype(np.float32)
    codes, scale = tq.encode_q8(torch.from_numpy(x), block=256, rounding="up")
    dec = tq.decode_q8(codes, scale, x.size).numpy()
    amax = np.repeat(np.abs(x.reshape(-1, 256)).max(axis=1), 256)
    assert np.all(dec >= x)
    assert np.all(dec - x <= amax / 126 * (1 + 1e-6))


def test_integer_sums_exact_below_the_bound():
    x = np.random.RandomState(0).randint(-127, 128, size=1000).astype(np.float32)
    codes, scale = tq.encode_q8(torch.from_numpy(x))
    np.testing.assert_array_equal(torch.round(tq.decode_q8(codes, scale, 1000)).numpy(), x)


def test_blocks_tags_and_switches_as_jax(monkeypatch):
    monkeypatch.delenv("METRICS_TPU_QUANT_BLOCK", raising=False)
    assert tq.default_block() == jq.default_block() == 256
    assert tq.default_block(torch.float64) == jq.default_block(jnp.float64) == 128
    for raw in ("64", "2", "nope"):
        monkeypatch.setenv("METRICS_TPU_QUANT_BLOCK", raw)
        assert tq.default_block(torch.float64) == jq.default_block(jnp.float64)
    for codec in (None, tq.QuantCodec("q8"), tq.QuantCodec("q8", rounding="up"), tq.QuantCodec("pack", bits=5)):
        jcodec = None if codec is None else jq.QuantCodec(*codec)
        assert tq.wire_tag(codec, "int32") == jq.wire_tag(jcodec, "int32")
    assert [tq.bits_for_bound(b) for b in (0, 1, 19, 255, 256)] == [jq.bits_for_bound(b) for b in (0, 1, 19, 255, 256)]
    for raw, on in (("0", False), ("off", False), ("1", True)):
        monkeypatch.setenv("METRICS_TPU_QUANT_SYNC", raw)
        assert tq.quant_enabled() is jq.quant_enabled() is on
