"""The port's paper-figure benchmarks emit the reference's rows: for fig3,
fig5, fig7 and table1 the row names and derived keys of one run at a few
hundred trials on the CPU equal those of the reference module's ``run``
(``benchmarks/``) at the same trials (fig4 and fig9 in
tests/test_torch_bench_rows_load.py).  The values are not compared: the two
frameworks draw different numbers (tests/test_torch_theory.py and the
engine's own tests compare distributions)."""
import pytest

from benchmarks import common as jcommon
from benchmarks import (fig3_delays as j3, fig5_ec2 as j5,
                        fig7_vs_target as j7, table1_e2e as jt1)
from benchmarks_torch import common as tcommon
from benchmarks_torch import (fig3_delays as t3, fig5_ec2 as t5,
                              fig7_vs_target as t7, table1_e2e as tt1)

TRIALS = 300
PAIRS = {
    "fig3": (lambda: j3.run(TRIALS), lambda: t3.run(TRIALS, "cpu")),
    "fig5": (lambda: j5.run(TRIALS), lambda: t5.run(TRIALS, "cpu")),
    "fig7": (lambda: j7.run(TRIALS), lambda: t7.run(TRIALS, "cpu")),
    "table1": (jt1.run, lambda: tt1.run("cpu")),
}


def _keys(rows):
    return [(r["name"], sorted(r["derived"])) for r in rows]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_rows_and_derived_keys_equal_the_references(name):
    ref_run, port_run = PAIRS[name]
    jcommon.drain_rows()
    ref_run()
    want = _keys(jcommon.drain_rows())
    tcommon.drain_rows()
    port_run()
    got = _keys(tcommon.drain_rows())
    assert got == want

