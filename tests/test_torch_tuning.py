"""The port's tuning layer (`spmv_tpu_torch/ops/tuning.py`) beside the
reference's (`tests/test_tuning.py`): every row and fallback gives a
usable policy, a card with no row falls back to the measured H100 row
with a one-time hint (as the reference's chips fall back to v5e), the
override and the JSON table round-trip, and the CPU row is the
reference's."""

import numpy as np
import pytest
import torch

from spmv_tpu.ops import tuning as jtuning
from spmv_tpu_torch.io.generate import power_law_csr
from spmv_tpu_torch.kernels.stream import StreamPolicy
from spmv_tpu_torch.ops import tuning

HINT = "no measured tuning row"


@pytest.fixture(autouse=True)
def fresh_hints(monkeypatch):
    """Each test sees the one-time hints unprinted and no override."""
    monkeypatch.setattr(tuning, "_warned_unmeasured", set())
    tuning.set_active(None)
    yield
    tuning.set_active(None)


@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("chip", ["h100", "h200", "a100", "nvidia rtx 6000 ada generation",
                                  "cpu"])
def test_policy_tables_cover_rows_and_fallbacks(chip, width):
    pol = tuning.policy_for(width, chip=chip)
    assert pol.kappa % 2048 == 0
    assert 2048 <= pol.kappa <= 16384


@pytest.mark.parametrize("width", [2, 4, 8])
def test_h100_row_prints_no_hint(capsys, width):
    tuning.policy_for(width, "h100")
    tuning.dispatch_fields(width, "h100")
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("chip", ["h200", "a100", "l40s", "nvidia rtx 6000 ada generation"])
def test_card_without_a_row_takes_the_h100_row_and_one_hint(capsys, chip):
    assert chip not in tuning.CHIP_TABLES
    for width in (2, 4, 8):
        assert tuning.policy_for(width, chip) == tuning.policy_for(width, "h100")
        assert tuning.dispatch_fields(width, chip) == tuning.dispatch_fields(width, "h100")
    err = capsys.readouterr().err
    assert err.count(HINT) == 1
    assert f"{chip!r}" in err and "using the h100 row" in err
    tuning.policy_for(4, chip)
    assert capsys.readouterr().err == ""  # once per chip


def test_h100_row_widths():
    row = tuning.CHIP_TABLES["h100"]
    assert set(row) == {2, 4}  # the card refuses 8-byte values
    assert tuning.policy_for(8, "h100") == StreamPolicy()
    for width in (2, 4):
        pol = tuning.policy_for(width, "h100")
        assert pol == StreamPolicy(**row[width])
        assert pol.kappa in tuning.KAPPAS
        # the port's scan kernels ignore scan_sbt: the row carries the
        # reference's 8
        assert pol.scan_sbt == jtuning.CHIP_TABLES["v5e"][width]["scan_sbt"] == 8


def test_dispatch_fields_per_row():
    assert tuning.dispatch_fields(4, "h100") == {"scan_sbt": 8}
    assert tuning.dispatch_fields(2, "h100") == {"scan_sbt": 8}
    assert tuning.dispatch_fields(8, "h100") == {}
    assert tuning.dispatch_fields(4, "cpu") == {}


@pytest.mark.parametrize("width", [2, 4, 8])
def test_cpu_row_is_the_references(width):
    """The CPU tests plan under the reference's CPU geometry."""
    assert tuning.CHIP_TABLES["cpu"][width] == jtuning.CHIP_TABLES["cpu"][width]
    assert tuning.policy_for(width, "cpu").structural_fields() == \
        jtuning.policy_for(width, chip="cpu").structural_fields()


def test_set_active_overrides_every_row_and_the_table_round_trips(tmp_path):
    fields = {"kappa": 8192, "scan_sbt": 16}
    tuning.set_active(fields)
    for chip in ("h100", "a100", "cpu"):
        assert tuning.policy_for(4, chip) == StreamPolicy(**fields)
        assert tuning.dispatch_fields(4, chip) == {"scan_sbt": 16}
    tuning.set_active(None)
    assert tuning.policy_for(4, "h100") == StreamPolicy(**tuning.CHIP_TABLES["h100"][4])
    path = str(tmp_path / "table.json")
    tuning.save_table(fields, path, chip="h100")
    tuning.save_table({"kappa": 10240}, path, chip="a100")
    assert tuning.load_table(path, chip="h100") == fields
    assert tuning.policy_for(4, "cpu") == StreamPolicy(**fields)
    assert tuning.load_table(path, chip="a100") == {"kappa": 10240}
    assert tuning.policy_for(2, "h100").kappa == 10240
    assert tuning.load_table(str(tmp_path / "none.json"), chip="h100") is None


def test_autotune_refit_and_override(tmp_path):
    """tests/test_tuning.py's refit on the port: the sweep's winner
    installs as the override and survives a save and a load."""
    A = power_law_csr(3000, 3000, 24000, seed=1)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(3000).astype(np.float32))
    fields, sweep = tuning.autotune_stream(A, x, kappas=(8192, 12288), iters=4, verbose=False)
    assert fields["kappa"] in (8192, 12288)
    assert {r["kappa"] for r in sweep} <= {8192, 12288} and len(sweep) >= 1
    tuning.set_active(fields)
    assert tuning.policy_for(4).kappa == fields["kappa"]
    path = str(tmp_path / "table.json")
    tuning.save_table(fields, path)
    tuning.set_active(None)
    assert tuning.load_table(path) == fields
    assert tuning.policy_for(4).kappa == fields["kappa"]


def test_med3_kernel_s_is_the_median_of_three(monkeypatch):
    from spmv_tpu_torch.utils import timing

    samples = iter([(0.0, 3.0), (0.0, 1.0), (0.0, 2.0)])
    monkeypatch.setattr(timing, "benchmark_fn", lambda fn, x, iters: next(samples))
    assert tuning.med3_kernel_s(None, None) == 2.0
