"""B3's share of its roofline, in %, in the staged cell: kernel B3
(``csrc/prefix_eval.cu`` via ``ops.prefix_eval``), timed by the
profiler's device trace by kernel name, against the least time its
traced requests needed: for each request, the larger of the AES table
lookups the walk needs over levels k..n-1 of that request's points at
the card's lookup rate (derived from shared memory; NVIDIA publishes no
AES rate) and its bytes at the card's memory rate.  Nothing where the
trace holds no B3 time or the card is not in ``peaks.json``."""

from portbench import roofline


def read(rec):
    return roofline.share(rec, "prefix_eval_kernel",
                          roofline.prefix_work_of_summary)
