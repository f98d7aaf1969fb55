"""On the card (skipped without one): the tiny cell's run through the
harness, and the control, on the device."""

import pytest

from zkbench import control, harness
from zkbench.reference import g1
from zkbench.tests.conftest import TINY_CELL, make_root

pytestmark = pytest.mark.gpu


def test_tiny_cell_on_the_card(card, tmp_path):
    r = harness.run(make_root(tmp_path), TINY_CELL, 2**31 + 7, 0.5, False, device=card)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"


def test_tiny_control_on_the_card(card, tmp_path):
    r = control.readings(make_root(tmp_path), TINY_CELL, 2**31 + 7, card, g1.GeneratorTable())
    assert r["bundle_mismatches"] > 0
