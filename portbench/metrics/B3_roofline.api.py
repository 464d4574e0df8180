"""B3's share of its roofline, in %, in the cell that goes through
``Dcf.eval``: the reading of ``B3_roofline.py``, kept apart because it
moves that cell's end-to-end rate, ``api_evals_per_s``."""

from portbench import roofline


def read(rec):
    return roofline.share(rec, "prefix_eval_kernel",
                          roofline.prefix_work_of_summary)
