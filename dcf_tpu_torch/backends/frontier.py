"""Frontier storage contract of the prefix-shared evaluators.

Counterpart of ``dcf_tpu/backends/frontier.py``.  A prefix evaluator
materializes a per-(key image, party) frontier: the top k walk levels
expanded once as a gather table, so that each eval walks only the
remaining n-k levels.  The frontier is key material (a pure function of
bundle, party and k, independent of the points); it lives in the backend
instance's ``_frontier`` dict, keyed by party, and ``invalidate_frontier``
(called by ``put_bundle``) is the one place that drops it.  Two backends
consume it: ``PrefixBackend`` (lam = 16; a table of 32-byte rows, kernels
B2 + B3) and ``LargeLambdaBackend`` with ``prefix_levels`` (lam >= 48;
64-byte rows plus a trajectory word per node, kernels B5a + B5b).  The JAX
package's serve-layer provider hook waits for the serving tier.

Subclass contract: provide ``_build_frontier_tables(b)`` (the uncached
build).
"""

from __future__ import annotations

__all__ = ["FrontierConsumerMixin"]


class FrontierConsumerMixin:
    """Get-or-build frontier tables through the instance store."""

    def invalidate_frontier(self) -> None:
        """Drop every cached frontier (a new key image)."""
        self._frontier: dict = {}

    def _frontier_tables(self, b: int):
        """Party ``b``'s frontier tables, built on first use."""
        b = int(b)
        tbl = self._frontier.get(b)
        if tbl is None:
            tbl = self._build_frontier_tables(b)
            self._frontier[b] = tbl
        return tbl
