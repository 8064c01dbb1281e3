"""Driver-level tests: each benchmark runs end-to-end on tiny configs and
its self-check invariants hold (SURVEY §4 items 3-4)."""

import sys
import pathlib

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def test_benchmark_00_runs():
    from benchmarks import benchmark_00

    res = benchmark_00.run(degree=2, n_cells=64)
    assert res.min > 0


def test_benchmark_01_matrix_and_eta():
    from benchmarks import benchmark_01
    from dealii_matrixfree_hanging_nodes.utils.params import BenchmarkParameters

    p = BenchmarkParameters(
        geometry_type="quadrant",
        n_refinements=3,
        degree=2,
        setup_only_fast_algorithm=False,
        print_details=False,
    )
    table = benchmark_01.run_benchmark([p], n_reps=2)
    row = table.rows()[0]
    assert row["n_cells_n"] + row["n_cells_hn"] == row["n_cells"]
    for k in ("t0", "t1", "t2", "t3", "t4", "t5", "t6", "t7"):
        assert row[k] > 0
    for k in ("eta1", "eta3", "eta5", "eta7"):
        assert row[k] >= 1.0  # eta clamps at 1 by definition


def test_benchmark_01_info_histograms():
    from benchmarks.benchmark_01 import Test

    t = Test(2, "quadrant", 3, dim=3, dtype=np.float64, n_reps=1)
    info = t.get_info()
    assert sum(info.mask_histogram.values()) == info.n_cells_hn
    assert sum(info.reduced_histogram.values()) == info.n_cells_hn
    assert all(0 < m < 512 for m in info.mask_histogram)


def test_benchmark_02_sweep():
    from benchmarks import benchmark_02

    table = benchmark_02.run("quadrant", 3, 1, weights=[1.0, 9.0], n_reps=1)
    assert table.n_rows() == 2


def test_benchmark_03_sweep():
    from benchmarks import benchmark_03

    table = benchmark_03.run("quadrant", 1, 2, 3, n_reps=1)
    rows = table.rows()
    assert rows[0]["n_dofs"] < rows[1]["n_dofs"]


def test_info_01_memory():
    from benchmarks import info_01

    table = info_01.run(2, 4, 4)
    for row in table.rows():
        if row["n_cells_hn"] > 0:
            assert row["mem_sp"] < row["mem_matrix"]


def test_params_json_roundtrip(tmp_path):
    from dealii_matrixfree_hanging_nodes.utils.params import (
        BenchmarkParameters,
        generate_parameter_files,
    )

    p = BenchmarkParameters(geometry_type="annulus", degree=3, vectorization_type="group")
    path = tmp_path / "cfg.json"
    p.to_json(str(path))
    q = BenchmarkParameters.from_json(str(path))
    assert q == p
    assert q.hn_mode == "all"
    files = generate_parameter_files(str(tmp_path / "bulk"), refinements=(4,), degrees=(1,))
    assert len(files) == 2 * 1 * 1 * 3


def test_table_output():
    from dealii_matrixfree_hanging_nodes.utils.table import ConvergenceTable

    t = ConvergenceTable()
    t.add_value("n", 10)
    t.add_value("t", 1.23456e-4)
    t.set_scientific("t", True)
    text = t.write_text()
    assert "n" in text and "1.2346e-04" in text


def test_solve_01_driver():
    from benchmarks import solve_01

    table = solve_01.run(2, 2)
    row = table.rows()[0]
    assert row["iters"] <= row["iters_unprec"]
    assert row["err"] < 1e-6


def test_elasticity_01_driver():
    from benchmarks import elasticity_01

    table = elasticity_01.run(nref=3, degree=2, n_windows=2, n_reps=2,
                              dtype=np.float64)
    row = table.rows()[0]
    assert row["n_dofs_total"] == 3 * (row["n_dofs_total"] // 3)
    assert row["time_min"] > 0 and row["time_min_plain"] > 0


def test_variant_matrix_all_runners_agree():
    """The four HN runners produce identical t-matrix censuses and all
    time positively (the timing itself is hardware-dependent)."""
    from benchmarks import benchmark_01
    from dealii_matrixfree_hanging_nodes.utils.params import (
        BenchmarkParameters,
    )

    rows = []
    for v in ("index", "sorted", "group", "matrix"):
        p = BenchmarkParameters(
            geometry_type="quadrant",
            n_refinements=3,
            degree=2,
            setup_only_fast_algorithm=True,
            vectorization_type=v,
        )
        table = benchmark_01.run_benchmark([p], n_reps=1)
        rows.append(table.rows()[-1])
    # cell-level census is variant-independent; the BATCH census is not
    # (the sorted runner repacks batches by mask, like the reference's
    # categorize option, benchmark_01.h:258-284)
    for k in ("n_cells", "n_cells_hn", "n_dofs"):
        assert len({r[k] for r in rows}) == 1
    for r in rows:
        assert r["t5"] > 0
