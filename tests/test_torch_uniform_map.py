"""The conversion-free uniform map of csrc/philox.cuh
(`bits_to_uniform_bitcast`, used by K2, K9, K10 and K11) against the port's
plain `bits_to_uniform` on every value of the top 23 bits: the kernels' map
puts the bits in the mantissa of a float in [1, 2) and subtracts
float32(1 - 2^-24), emulated here with numpy's float32 view."""

import numpy as np
import torch

from mcos_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)


def _bitcast_map(m: np.ndarray) -> np.ndarray:
    one_plus = (m.astype(np.uint32) | np.uint32(0x3F800000)).view(np.float32)
    return one_plus - np.array(0x3F7FFFFF, np.uint32).view(np.float32)


def test_bitcast_map_equals_bits_to_uniform_on_every_mantissa():
    m = np.arange(1 << 23, dtype=np.uint32)
    fast = _bitcast_map(m)
    assert fast.dtype == np.float32
    plain = ck.bits_to_uniform(torch.from_numpy(m.astype(np.int64) << 9))
    assert plain.dtype == torch.float32
    np.testing.assert_array_equal(fast.view(np.uint32),
                                  plain.numpy().view(np.uint32))


def test_bitcast_map_lies_strictly_inside_the_unit_interval():
    m = np.arange(1 << 23, dtype=np.uint32)
    fast = _bitcast_map(m)
    assert fast.min() > 0.0 and fast.max() < 1.0
    assert fast.min() == np.float32(2.0 ** -24)
    assert fast.max() == np.float32(1.0 - 2.0 ** -24)
    # Only the top 23 bits count: the low 9 bits of a word change nothing.
    words = (m[::4097] << 9) | np.uint32(0x1FF)
    low = ck.bits_to_uniform(torch.from_numpy(words.astype(np.int64)))
    np.testing.assert_array_equal(low.numpy(), fast[::4097])
