"""Frontier storage contract of the prefix-shared evaluators.

Counterpart of ``dcf_tpu/backends/frontier.py``.  A prefix evaluator
materializes a per-(key image, party) frontier: the top k walk levels
expanded once as a gather table, so that each eval walks only the
remaining n-k levels.  The frontier is key material (a pure function of
bundle, party and k, independent of the points), so where it is cached is
a policy question, not a correctness one:

* **instance store** (default): the frontier lives in the backend
  instance's ``_frontier`` dict, keyed by party, and dies with it.  Right
  for the bare staged API, where one instance holds one bundle.
* **frontier provider** (the serving tier): ``frontier_provider`` is
  bound after ``put_bundle`` to an object with one method
  ``get(party, k, build)``; the backend then consults it on every
  ``_frontier_tables`` call and never touches its local store.
  ``serve.frontier_cache.FrontierCache`` binds one provider per (key_id,
  registration generation), so the expanded frontier survives residency
  eviction and is shared by re-staged instances of the same key.

``invalidate_frontier`` is the one invalidation hook: re-staging a new
bundle onto an instance (``put_bundle``) and the serve registry evicting
the owning entry both route through it, clearing the local store and
unbinding the provider (a provider bound to the previous key image must
never serve the next one).

Two backends consume it: ``PrefixBackend`` (lam = 16; a table of 32-byte
rows, kernels B2 + B3) and ``LargeLambdaBackend`` with ``prefix_levels``
(lam >= 48; 64-byte rows plus a trajectory word per node, kernels B5a +
B5b).  Subclass contract: provide ``_k()`` (the effective prefix depth
for the held bundle) and ``_build_frontier_tables(b)`` (the uncached
build).
"""

from __future__ import annotations

from dcf_tpu_torch.utils.tracing import span

__all__ = ["FrontierConsumerMixin"]


class FrontierConsumerMixin:
    """Get-or-build frontier tables through the instance store or a bound
    provider (see the module docstring)."""

    #: Bound by the owner of the key-id namespace (the serve registry);
    #: None = the instance-local store.  Must expose
    #: ``get(party, k, build)`` returning the (possibly cached) tables.
    frontier_provider = None

    def invalidate_frontier(self) -> None:
        """Drop the instance store and unbind the provider (a new key
        image, or the serve registry evicting the owning entry)."""
        self._frontier: dict = {}
        self.frontier_provider = None

    def ensure_frontier(self, b: int) -> None:
        """Build (or fetch from the provider) party ``b``'s frontier now:
        the serve registry calls this at stage time, so the expansion runs
        off the eval clock of later batches."""
        self._frontier_tables(int(b))

    def _frontier_tables(self, b: int):
        """Party ``b``'s frontier tables, cached in the bound provider
        (keyed (key_id, generation, party, k) there) or the instance
        store (keyed by party), built on first use."""
        b = int(b)
        prov = self.frontier_provider
        if prov is not None:
            return prov.get(b, self._k(), lambda: self._frontier_build(b))
        tbl = self._frontier.get(b)
        if tbl is None:
            tbl = self._frontier_build(b)
            self._frontier[b] = tbl
        return tbl

    def _frontier_build(self, b: int):
        """One uncached build, inside the ``frontier_build`` span (a hit
        opens none)."""
        with span("frontier_build"):
            return self._build_frontier_tables(b)
