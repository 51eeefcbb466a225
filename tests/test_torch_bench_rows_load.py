"""The port's Fig. 4 (completion time vs load) and Fig. 9 (message budget)
benchmarks emit the reference's rows: row names and derived keys equal those
of the reference module's ``run`` (``benchmarks/``) on the CPU.  The values
are not compared: the two frameworks draw different numbers."""
from benchmarks import common as jcommon
from benchmarks import fig4_vs_load as j4, fig9_multimessage as j9
from benchmarks_torch import common as tcommon
from benchmarks_torch import fig4_vs_load as t4, fig9_multimessage as t9


def _keys(rows):
    return [(r["name"], sorted(r["derived"])) for r in rows]


def test_fig4_rows_equal_the_references():
    jcommon.drain_rows()
    j4.run(300)
    want = _keys(jcommon.drain_rows())
    tcommon.drain_rows()
    t4.run(300, "cpu")
    assert _keys(tcommon.drain_rows()) == want


def test_fig9_rows_equal_the_references():
    """fig9 at the harness's quick scale (4000 trials: its guards are
    statistical, and both sides must pass them to emit every row)."""
    jcommon.drain_rows()
    j9.run(4000)
    want = _keys(jcommon.drain_rows())
    tcommon.drain_rows()
    t9.run(4000, "cpu")
    assert _keys(tcommon.drain_rows()) == want
    assert (t9.N, t9.R, t9.K, t9.BUDGETS, t9.K_EPS, t9.EPS_GRID) == (
        j9.N, j9.R, j9.K, j9.BUDGETS, j9.K_EPS, j9.EPS_GRID)
