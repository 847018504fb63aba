"""The compiled kernels on the card (``-m gpu``; skipped without one).

    GNUAIS_TEST_GPU=1 python -m pytest tests/test_gpu.py

The CPU tiers run the same kernel bodies in the Pallas interpreter;
these tests check what only the card can: the Triton-compiled kernel
against XLA's plain chain at a real block length, the FIR's float32
arithmetic bitwise, and the on-device CRC filter's bf16 products.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gnuais_tpu.golden.model import GoldenFir
from gnuais_tpu.ops import fir, fused
from gnuais_tpu.runtime.pipeline import decode_block, init_carry
# imported by module name (pytest puts tests/ on sys.path): a machine
# with another top-level ``tests`` package installed shadows tests.*
from parity_utils import carry_equal, frames_equal, noisy_batch

pytestmark = pytest.mark.gpu


def test_compiled_kernel_matches_plain_chain(gpu):
    s, t = 64, 49_152
    x = jnp.asarray(noisy_batch(s, t, seed=1, n_payloads=20, gap_bits=40))
    c0 = init_carry(s)
    for nv in (t, t - 1001):
        c1, f1, _ = decode_block(x, jnp.int32(nv), c0, frame_slots=32,
                                 block_base=jnp.int32(123))
        c2, f2, _ = decode_block(x, jnp.int32(nv), c0, frame_slots=32,
                                 block_base=jnp.int32(123),
                                 fused_pipeline=True)
        frames_equal(f1, f2)
        carry_equal(c1, c2)
        assert int(jnp.sum(f2.count)) > s


def test_compiled_fir_is_bit_exact(gpu):
    """Kernel FIR == XLA's fir_exact == the NumPy model, bit for bit,
    onsets after digital silence (subnormal taps) included."""
    x = noisy_batch(16, 8192, seed=2, n_payloads=3)
    x[::3, :2000] = 0
    hist = np.zeros((16, 36), np.float32)
    want = np.stack([GoldenFir().run(r) for r in x]).view(np.uint32)
    xla, _ = fir.fir_exact(jnp.asarray(x), jnp.asarray(hist))
    kern = fused.fir_fused(jnp.asarray(x), jnp.asarray(hist))
    assert np.array_equal(np.asarray(xla).view(np.uint32), want)
    assert np.array_equal(np.asarray(kern).view(np.uint32), want)


def test_device_crc_filter_on_card(gpu):
    """The on-device CRC pass (bf16 one-hot compaction, CRC matmul)
    keeps exactly the frames the host CRC accepts."""
    s, t = 32, 49_152
    x = noisy_batch(s, t, seed=3, n_payloads=20, gap_bits=40)
    x[5, 20_000:20_005] = -x[5, 20_000:20_005]           # one bad FCS
    xj = jnp.asarray(x)
    c0 = init_carry(s)
    _c, host, _ = decode_block(xj, jnp.int32(t), c0, frame_slots=32,
                               fused_pipeline=True)
    _c, dev, _ = decode_block(xj, jnp.int32(t), c0, frame_slots=32,
                              fused_pipeline=True, device_crc=True)
    from gnuais_tpu.runtime.pipeline import extract_frames
    ok = [[f for f in lst if f.crc_ok] for lst in extract_frames(host)]
    got = extract_frames(dev)
    n_bad = int(jnp.sum(host.count)) - sum(len(o) for o in ok)
    assert int(jnp.sum(dev.crcfail)) == n_bad
    for a, b in zip(ok, got):
        assert [f.payload_bits.tolist() for f in a] == \
               [f.payload_bits.tolist() for f in b]
