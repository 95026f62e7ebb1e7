"""The wrappers' device caches of host tables (K9's (4, steps) step table
and count table, K10/K11's (2, steps) step table): built once per table,
found again on a second call with the same bytes, and built without
torch's warning about a read-only buffer."""

import warnings

import numpy as np
import torch

from mcos_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)


def _no_warning(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return fn(*args)


def test_step_table_cache_is_writable_and_found_again():
    for rows, steps in ((2, 37), (4, 512)):
        tab = np.random.default_rng(rows).random((rows, steps),
                                                 dtype=np.float32)
        a = _no_warning(ck._device_step_table, tab.tobytes(), steps, "cpu")
        assert a.shape == (rows, steps) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), tab)
        hits = ck._device_step_table.cache_info().hits
        b = _no_warning(ck._device_step_table, tab.tobytes(), steps, "cpu")
        assert b is a
        assert ck._device_step_table.cache_info().hits == hits + 1


def test_count_table_cache_is_found_again():
    lam_dt = np.full(64, 0.01) * np.linspace(1.0, 3.0, 64)
    a = _no_warning(ck._device_td_table, lam_dt.tobytes(), "cpu")
    np.testing.assert_array_equal(a.numpy(),
                                  ck.poisson_binom_count_table(lam_dt))
    assert _no_warning(ck._device_td_table, lam_dt.tobytes(), "cpu") is a
