"""The `options` traffic generator: seeded, repeatable, the same work for
every seed."""

import collections

from perfbench import harness

CELLS = ("svj_nifty.quote_c8", "rough_heston_lift.price_c2",
         "svj_nifty.greeks_wide_c2")


def _cell(name):
    return harness.Cell(name)


def test_a_seed_repeats_its_traffic_exactly():
    for name in CELLS:
        cell = _cell(name)
        a = cell.generator.generate(cell.config, cell.mix, 2**33 + 7)
        b = cell.generator.generate(cell.config, cell.mix, 2**33 + 7)
        assert a == b


def test_a_new_seed_changes_the_traffic():
    for name in CELLS:
        cell = _cell(name)
        a = cell.generator.generate(cell.config, cell.mix, 11)
        b = cell.generator.generate(cell.config, cell.mix, 12)
        assert a != b


def test_every_seed_offers_the_same_work_per_block():
    cell = _cell("svj_nifty.quote_c8")
    mix = cell.mix
    size = sum(mix["expiry_per_block"])
    for seed in (1, 2, 3**20):
        bodies = cell.generator.generate(cell.config, mix, seed)
        assert len(bodies) == size * mix["blocks"]
        for lo in range(0, 10 * size, size):
            block = bodies[lo:lo + size]
            days = collections.Counter(
                round(b["T"] * cell.config["market"]["day_count"])
                for b in block)
            assert days == dict(zip(mix["expiry_days"],
                                    mix["expiry_per_block"]))
            assert sum(b["is_call"] for b in block) == mix["calls_per_block"]


def test_contracts_keep_to_the_mix():
    cell = _cell("rough_heston_lift.price_c2")
    market = cell.config["market"]
    bodies = cell.generator.generate(cell.config, cell.mix, 5)
    for b in bodies:
        lo, hi = cell.mix["spot_rel"]
        assert market["spot"] * (1 + lo) - 0.01 <= b["spot"] <= \
            market["spot"] * (1 + hi) + 0.01
        assert b["strike"] % market["strike_grid"] == 0
        k_lo, k_hi = cell.mix["strike_rel"]
        assert b["spot"] * (1 + k_lo) <= b["strike"] <= b["spot"] * (1 + k_hi)
        assert b["mode"] == "price" and b["num_paths"] == 200_000
    assert {round(b["T"] * 365) for b in bodies} == \
        set(cell.mix["expiry_days"])


def test_warm_bodies_cover_every_shape():
    cell = _cell("svj_nifty.quote_c8")
    warm = cell.generator.warm_bodies(cell.config, cell.mix)
    assert sorted(round(b["T"] * 365) for b in warm) == [7, 14, 28, 91]


def test_the_longest_request_is_the_latest_expiry():
    cell = _cell("svj_nifty.quote_c8")
    bodies = cell.generator.generate(cell.config, cell.mix, 3)
    longest = max(bodies, key=cell.generator.length)
    assert round(longest["T"] * 365) == 91
