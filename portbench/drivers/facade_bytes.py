"""Traffic driver ``facade_bytes``: ``Dcf.eval``, bytes in and bytes out.

Request i is ``Dcf.eval(party, bundle, xs)`` on the host points of batch
i mod ``batches``; the facade stages them, evaluates and fetches the
answers to the host.  Between requests the batch just used gets fresh
points (``_dcf``): the host array is XORed in place with the next mask,
as a server's receive buffer is filled anew.  The keys ship with the
first request, in the warm-up.
"""

from __future__ import annotations

from portbench.drivers import _dcf

inputs = _dcf.make_inputs
geometry = _dcf.geometry
points_summary = _dcf.points_summary


def setup(cell, mark) -> None:
    _dcf.build_facade(cell, mark)
    cell.state["current"] = [xs.copy() for xs in cell.host["base"]]


def request(cell, i: int):
    batch = _dcf.log(cell, i)
    with cell.span("facade_eval"):
        return cell.state["dcf"].eval(cell.inputs["party"],
                                      cell.state["bundle"],
                                      cell.state["current"][batch])


def sample(cell, i: int, out, plan: int):
    q, answers = _dcf.query(cell, i, plan)
    return q, answers, _dcf.gather(cell, out, plan)


def advance(cell, i: int) -> None:
    current = cell.state["current"]
    _dcf.refresh_host(cell, i, current[i % len(current)])
