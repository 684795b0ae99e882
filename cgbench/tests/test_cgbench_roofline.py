"""The byte and operation counts of the routing kernels and of a whole
slot, at small shapes, against counts written out by hand."""
import pytest

from cgbench.harness import roofline

BASE = dict(n_workers=4, alpha=2, slot_len=1024, n_sources=2, block_size=16,
            sketch_depth=3, sketch_width=8, max_moves_per_slot=2)


def test_hh_scan_work():
    cg = dict(BASE)
    V, S, D, W, m = 8, 2, 3, 8, 1024
    state = 4 * (V + S * V + D * W + S * D * W)
    assert roofline.hh_scan_work(cg) == (8 * m + 2 * state,
                                         m * (D * 24 + 8 + 24 + 1))


def test_porc_assign_work():
    cg = dict(BASE, n_sources=1)
    assert roofline.porc_assign_work(cg) == (8 * 1024 + 2 * 4 * 8,
                                             1024 * (22 + 5))


def test_delegation_work():
    cg = dict(BASE)
    V, n, m = 8, 4, 1024
    assert roofline.delegation_work(cg) == (
        8 * m + 16 * (V + n), 2 * m + 16 * (V + n) + 2 * 2 * V)


@pytest.mark.parametrize("hh,engine,route", [
    ("WCHOICES", "auto", roofline.hh_scan_work),
    ("", "strict", roofline.porc_assign_work)])
def test_slot_work_is_routing_plus_the_rest(hh, engine, route):
    cg = dict(BASE, hh_scheme=hh, engine=engine)
    rb, ro = route(cg)
    db, do = roofline.delegation_work(cg)
    assert roofline.slot_work(cg) == (rb + db, ro + do)


def test_bound_takes_the_larger():
    assert roofline.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert roofline.bound_s(1.0, 67e12 * 2) == (2.0, "operations")
