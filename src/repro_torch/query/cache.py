"""Semantic result & subplan cache: the budgeted materialization layer.

The compiled-pipeline cache (``exec.Executor._compiled``) reuses only
pipelines; this module reuses *work*: whole results keyed by semantic
fingerprint, join builds (the pipeline breakers' state), selection index
bitmaps, materialized intermediate tables and trained GLM weights.  The
paper's MonetDB integration pays the data-movement bill on every query,
even when consecutive queries share selections and join builds; a hit here
skips the transfer and the recomputation.

Correctness comes from the key, not from flushing: fingerprints embed
every referenced table's version (``columnar.table.Table.version``), so a
mutation makes stale entries unreachable at once; ``invalidate_table``
also sweeps them out, so dead bytes never crowd the budget.

Admission and eviction are priced by the cost model
(``CostModel.cache_score``: recompute seconds avoided per resident byte,
scaled by observed reuse), so the cache keeps what is expensive to
rebuild, not what is big.  An entry is admitted only by evicting strictly
lower-scored residents; when the bytes cannot be freed that way the
candidate is rejected.

Selection bitmaps also support **predicate subsumption**: every admitted
bitmap registers its closed interval ``[lo, hi]`` in an index bucketed by
``(table, column, version)``, and ``lookup_superset`` returns the
tightest cached interval containing a requested range; the executor then
refines that bitmap instead of rescanning the column when the cost model
says refinement wins.

Residency is tiered: ``budget_bytes`` prices the device tier, and
``host_budget_bytes`` opens a second tier in host memory.  A device
eviction victim is *demoted*: every tensor of its value is copied to the
CPU and the device reference dropped, so its device bytes are really
freed, while its key stays resident and hittable.  Only the bottom tier
evicts for real.  A host hit is promoted back to the device tier when free
room (and the tenant's device share) allows.  Torch operations do not mix
devices, so a consumer takes a hit's value through ``device_value``, which
copies a host-tier value onto its device whether or not it was promoted.
``host_budget_bytes=0`` (the default) disables the host tier.

The cache may be shared by several executors over one catalog.  One
re-entrant lock guards every surface, and ``sync_versions`` is the drift
guard: whichever executor notices a table version move sweeps everyone's
dependent entries.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Hashable, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.columnar.table import Column, Table
from repro_torch.device import DeviceLike, resolve
from repro_torch.query import telemetry as tm

DEFAULT_BUDGET_BYTES = 64 << 20          # 64 MiB of materialized state


def _to_host(value):
    """A value with every tensor copied to host memory, so a demotion
    frees the device tier instead of re-labelling it.  A tensor becomes a
    CPU tensor of the same dtype; a Table's columns become host (numpy)
    columns, keeping its name, plan and version.  Anything else (numpy,
    Python scalars) is already on the host."""
    if isinstance(value, Table):
        return Table(value.name,
                     {k: Column(c.data.cpu().numpy()
                                if isinstance(c.data, torch.Tensor)
                                else np.asarray(c.data), k, "host")
                      for k, c in value.columns.items()},
                     value.plan, value.version)
    if isinstance(value, tuple):
        return tuple(_to_host(v) for v in value)
    if isinstance(value, list):
        return [_to_host(v) for v in value]
    if isinstance(value, torch.Tensor):
        return value.cpu()
    return value


def _to_device(value, device: torch.device):
    """The inverse of ``_to_host``: every tensor, and every column of a
    Table, on ``device``.  A value already there is returned as is, and
    numpy arrays and scalars pass through (they were never tensors)."""
    if isinstance(value, Table):
        return Table(value.name,
                     {k: Column(c.data.to(device)
                                if isinstance(c.data, torch.Tensor)
                                else torch.from_numpy(
                                    np.array(c.data)).to(device), k)
                      for k, c in value.columns.items()},
                     value.plan, value.version)
    if isinstance(value, tuple):
        return tuple(_to_device(v, device) for v in value)
    if isinstance(value, list):
        return [_to_device(v, device) for v in value]
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return value


def cache_disabled() -> bool:
    """The REPRO_CACHE=0 switch: force-disables the semantic cache in
    every executor (``Executor.install_cache`` is a no-op under it) and
    skips the tests marked ``requires_cache``.  Parsed as the reference
    parses it."""
    return os.environ.get("REPRO_CACHE", "1").lower() in ("0", "off", "no")


@dataclasses.dataclass
class CacheEntry:
    key: Hashable
    kind: str                     # result | subplan | build | bitmap | model
    value: object
    n_bytes: int
    recompute_s: float
    tables: Tuple[str, ...]              # dependency sweep index
    hits: int = 0
    tick: int = 0                        # last-touch order (LRU tiebreak)
    # (table, column, version, lo, hi) for interval-indexed bitmaps
    interval: Optional[Tuple[str, str, int, int, int]] = None
    # owning tenant (None = shared) for byte-share accounting
    tenant: Optional[str] = None
    # residency tier ("device" | "host"): host entries hold CPU tensors
    # (host columns for Tables) and count against host_budget_bytes
    tier: str = "device"

    def score(self, model) -> float:
        return model.cache_score(self.recompute_s, self.n_bytes, self.hits)


class SemanticCache:
    """Byte-budgeted store of materialized query state.

    ``model`` is the executor's ``CostModel``: the object that prices
    physical plans prices residency too.  ``device`` is where device-tier
    values live and promotions go (``repro_torch.device.resolve``: the
    card unless named); ``Executor.install_cache`` sets it to the
    executor's device when it was left unset.
    """

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET_BYTES, *,
                 model=None, telemetry: Optional[tm.Telemetry] = None,
                 host_budget_bytes: int = 0, device: DeviceLike = None):
        if model is None:
            from repro_torch.query.cost import CostModel
            model = CostModel(1)
        self.model = model
        # admission / rejection / eviction decisions emit instant events
        # with the scores that decided them (no-ops when disabled)
        self.tel = telemetry if telemetry is not None else tm.get()
        self._device = resolve(device) if device is not None else None
        self.budget_bytes = int(budget_bytes)
        # host (demotion) tier budget; 0 disables the tier
        self.host_budget_bytes = int(host_budget_bytes)
        self._entries: Dict[Hashable, CacheEntry] = {}
        # (table, column, version) -> {entry key: (lo, hi)}: the
        # subsumption index over admitted selection bitmaps
        self._intervals: Dict[Tuple[str, str, int],
                              Dict[Hashable, Tuple[int, int]]] = {}
        self._hinted: set = set()
        # one lock for every surface: executors sharing the cache admit,
        # evict and look up concurrently, so the index and the byte books
        # must never be seen mid-update
        self._lock = threading.RLock()
        # tenant -> relative weight; a tenant's byte cap is its share of
        # the device budget.  Empty: no partitioning, every put uncapped
        self._tenant_shares: Dict[str, float] = {}
        # per-tier tenant byte books (device, host)
        self._tenant_bytes: Dict[str, int] = {}
        self._tenant_bytes_host: Dict[str, int] = {}
        self._seen_versions: Dict[str, int] = {}
        self._tick = 0
        self.used_bytes = 0
        self.host_used_bytes = 0
        self.demoted = 0
        self.promoted = 0
        self.hits = 0
        self.misses = 0
        self.admitted = 0
        self.rejected = 0
        self.evicted = 0
        self.invalidated = 0
        self.subsumption_hits = 0
        self.subsumption_misses = 0

    @property
    def device(self) -> torch.device:
        """Where device-tier values live: the card unless set."""
        return self._device if self._device is not None else resolve(None)

    @device.setter
    def device(self, device: DeviceLike) -> None:
        self._device = resolve(device)

    @property
    def device_set(self) -> bool:
        return self._device is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    # -- lookup ------------------------------------------------------------- #

    def get(self, key: Hashable) -> Optional[CacheEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            e.hits += 1
            self._tick += 1
            e.tick = self._tick
            if e.tier == "host":
                # promote back to the device tier when free room (and the
                # tenant's device share) allows
                self._promote_locked(e)
            return e

    def peek(self, key: Hashable) -> Optional[CacheEntry]:
        """Lookup without touching hit / recency accounting."""
        with self._lock:
            return self._entries.get(key)

    def device_value(self, entry: CacheEntry,
                     device: Optional[torch.device] = None):
        """``entry``'s value on ``device`` (the cache's by default): a
        device-tier value as stored, a host-tier one copied up outside
        the lock, whether or not the hit was promoted.  The value is
        handed out as stored: callers must not write into it."""
        with self._lock:
            value = entry.value
        return _to_device(value, self.device if device is None else device)

    def lookup_superset(self, table: str, column: str, version: int,
                        lo: int, hi: int, accept=None
                        ) -> Optional[Tuple[CacheEntry, Tuple[int, int]]]:
        """Subsumption lookup: the tightest cached selection bitmap whose
        closed interval contains ``[lo, hi]`` over this exact
        ``(table, column, version)``.  Tightest = smallest span, ties
        broken by the most recent touch, so a narrowing ladder refines
        from the narrowest ancestor still resident.  An empty request
        (``lo > hi``) is contained in any cached interval.  ``accept``
        (entry -> bool) filters candidates before anything is counted:
        the executor passes its pricing gate, so a superset too wide to
        be worth refining registers no hit and no touch.  Returns
        ``(entry, (clo, chi))`` or None; a returned entry is touched like
        an exact hit."""
        with self._lock:
            found = self._best_superset_locked(table, column, version,
                                               lo, hi, accept)
            if found is None:
                self.subsumption_misses += 1
                return None
            best_key, bounds = found
            self.subsumption_hits += 1
            return self.get(best_key), bounds

    def peek_superset(self, table: str, column: str, version: int,
                      lo: int, hi: int, accept=None
                      ) -> Optional[Tuple[CacheEntry, Tuple[int, int]]]:
        """``lookup_superset`` without touching any accounting: the
        executor's routing probe."""
        with self._lock:
            found = self._best_superset_locked(table, column, version,
                                               lo, hi, accept)
            if found is None:
                return None
            key, bounds = found
            return self._entries[key], bounds

    def _best_superset_locked(self, table, column, version, lo, hi,
                              accept=None):
        bucket = self._intervals.get((table, column, int(version)))
        best_key, best = None, None
        if bucket:
            for key, (clo, chi) in bucket.items():
                if not (lo > hi or (clo <= lo and chi >= hi)):
                    continue
                e = self._entries.get(key)
                if e is None:          # defensive: the index is swept on drop
                    continue
                if accept is not None and not accept(e):
                    continue
                cand = (chi - clo, -e.tick)
                if best is None or cand < best:
                    best, best_key = cand, key
        if best_key is None:
            return None
        return best_key, bucket[best_key]

    # -- admission / eviction ----------------------------------------------- #

    def hint(self, keys: Iterable[Hashable]) -> None:
        """Mark keys the caller knows will be reused (the optimizer's
        common subplans of an admitted batch): they are admitted as if hit
        once already.  Each call replaces the hint set."""
        with self._lock:
            self._hinted = set(keys)

    def set_tenant_shares(self, shares: Mapping[str, float]) -> None:
        """Install per-tenant relative weights.  A registered tenant may
        hold at most ``weight / sum(weights) * budget_bytes`` device
        bytes; an over-cap admission first evicts that tenant's own
        lower-scored entries, then is rejected, so one tenant's churn
        never displaces another's share.  Entries of ``tenant=None`` (or
        of an unregistered tenant) stay uncapped."""
        with self._lock:
            self._tenant_shares = {str(k): float(v)
                                   for k, v in shares.items() if v > 0}

    def tenant_cap_bytes(self, tenant: Optional[str]) -> Optional[int]:
        """Device-byte cap of ``tenant`` under the installed shares, or
        None when uncapped."""
        with self._lock:
            return self._tenant_cap_locked(tenant)

    def _tenant_cap_locked(self, tenant) -> Optional[int]:
        if tenant is None or not self._tenant_shares:
            return None
        w = self._tenant_shares.get(tenant)
        if w is None:
            return None
        total = sum(self._tenant_shares.values())
        return int(self.budget_bytes * w / total)

    # -- tier accounting (device <-> host) ---------------------------------- #

    def _account_add(self, e: CacheEntry) -> None:
        if e.tier == "host":
            self.host_used_bytes += e.n_bytes
            book = self._tenant_bytes_host
        else:
            self.used_bytes += e.n_bytes
            book = self._tenant_bytes
        if e.tenant is not None:
            book[e.tenant] = book.get(e.tenant, 0) + e.n_bytes

    def _account_sub(self, e: CacheEntry) -> None:
        if e.tier == "host":
            self.host_used_bytes -= e.n_bytes
            book = self._tenant_bytes_host
        else:
            self.used_bytes -= e.n_bytes
            book = self._tenant_bytes
        if e.tenant is not None:
            # zero removes the key; anything else, a negative included,
            # is stored as is for check_invariants to catch
            left = book.get(e.tenant, 0) - e.n_bytes
            if left:
                book[e.tenant] = left
            else:
                book.pop(e.tenant, None)

    def _evict(self, e: CacheEntry, *, displaced_by: str) -> None:
        """Displace a device-tier resident: demote it to the host tier
        when that budget allows (the entry stays hittable), else drop it.
        Host-tier residents (the bottom tier) always drop."""
        if e.tier == "device" and self._demote_locked(e):
            if self.tel.enabled:
                self.tel.instant("cache.demote", kind=e.kind,
                                 n_bytes=e.n_bytes,
                                 displaced_by=displaced_by)
            return
        self._drop(e)
        self.evicted += 1
        if self.tel.enabled:
            self.tel.instant("cache.evict", kind=e.kind, n_bytes=e.n_bytes,
                             score=e.score(self.model),
                             displaced_by=displaced_by)

    def _demote_locked(self, e: CacheEntry) -> bool:
        """Move a device entry to the host tier, winning its host bytes
        from strictly lower-scored host residents (the device tier's
        priced admission, one tier down).  The value's tensors are copied
        to the CPU and the entry drops its device references."""
        if self.host_budget_bytes <= 0 or e.n_bytes > self.host_budget_bytes:
            return False
        score = e.score(self.model)
        need = self.host_used_bytes + e.n_bytes - self.host_budget_bytes
        victims = []
        if need > 0:
            hosted = [h for h in self._entries.values() if h.tier == "host"]
            for h in sorted(hosted,
                            key=lambda h: (h.score(self.model), h.tick)):
                if h.score(self.model) >= score:
                    break
                victims.append(h)
                need -= h.n_bytes
                if need <= 0:
                    break
            if need > 0:
                return False
        for h in victims:
            self._drop(h)
            self.evicted += 1
            if self.tel.enabled:
                self.tel.instant("cache.evict", kind=h.kind, tier="host",
                                 n_bytes=h.n_bytes,
                                 score=h.score(self.model),
                                 displaced_by=e.kind)
        self._account_sub(e)
        e.value = _to_host(e.value)
        e.tier = "host"
        self._account_add(e)
        self.demoted += 1
        return True

    def _promote_locked(self, e: CacheEntry) -> None:
        """Bring a host-tier hit back onto the device tier iff it fits the
        free device room and the owner's share: promotion never starts an
        eviction fight."""
        if self.used_bytes + e.n_bytes > self.budget_bytes:
            return
        cap = self._tenant_cap_locked(e.tenant)
        if cap is not None and (self._tenant_bytes.get(e.tenant, 0)
                                + e.n_bytes) > cap:
            return
        self._account_sub(e)
        e.value = _to_device(e.value, self.device)
        e.tier = "device"
        self._account_add(e)
        self.promoted += 1
        if self.tel.enabled:
            self.tel.instant("cache.promote", kind=e.kind,
                             n_bytes=e.n_bytes)

    def put(self, key: Hashable, value: object, *, kind: str,
            n_bytes: int, recompute_s: float,
            tables: Iterable[str] = (),
            interval: Optional[Tuple[str, str, int, int, int]] = None,
            tenant: Optional[str] = None) -> bool:
        """Priced admission; returns whether the entry was admitted.
        ``interval=(table, column, version, lo, hi)`` registers a
        selection bitmap in the subsumption index.  ``tenant`` attributes
        the bytes for share enforcement.  The cache keeps ``value`` as
        given: the caller must not write into it afterwards."""
        with self._lock:
            return self._put_locked(key, value, kind=kind, n_bytes=n_bytes,
                                    recompute_s=recompute_s, tables=tables,
                                    interval=interval, tenant=tenant)

    def _put_locked(self, key, value, *, kind, n_bytes, recompute_s,
                    tables, interval, tenant=None) -> bool:
        n_bytes = max(int(n_bytes), 0)
        if n_bytes > self.budget_bytes:
            self.rejected += 1
            if self.tel.enabled:
                self.tel.instant("cache.reject", kind=kind,
                                 reason="over_budget", n_bytes=n_bytes)
            return False
        hinted = key in self._hinted
        if hinted:
            self._hinted.discard(key)
        old = self._entries.get(key)
        if old is not None:
            self._drop(old)
        cand = CacheEntry(key, kind, value, n_bytes, recompute_s,
                          tuple(tables), hits=1 if hinted else 0,
                          interval=interval, tenant=tenant)
        score = cand.score(self.model)
        victims = []
        seen = set()
        # the tenant's share first: free the owner's bytes down to its cap
        # from its own lower-scored entries, never another tenant's
        cap = self._tenant_cap_locked(tenant)
        if cap is not None:
            if n_bytes > cap:
                self.rejected += 1
                if self.tel.enabled:
                    self.tel.instant("cache.reject", kind=kind,
                                     reason="tenant_share", tenant=tenant,
                                     n_bytes=n_bytes, cap=cap)
                return False
            t_need = self._tenant_bytes.get(tenant, 0) + n_bytes - cap
            if t_need > 0:
                own = [e for e in self._entries.values()
                       if e.tenant == tenant and e.tier == "device"]
                for e in sorted(own, key=lambda e: (e.score(self.model),
                                                    e.tick)):
                    if e.score(self.model) >= score:
                        break
                    victims.append(e)
                    seen.add(e.key)
                    t_need -= e.n_bytes
                    if t_need <= 0:
                        break
                if t_need > 0:
                    self.rejected += 1
                    if self.tel.enabled:
                        self.tel.instant("cache.reject", kind=kind,
                                         reason="tenant_share",
                                         tenant=tenant, n_bytes=n_bytes,
                                         cap=cap, score=score)
                    return False
        need = (self.used_bytes - sum(v.n_bytes for v in victims)
                + n_bytes - self.budget_bytes)
        if need > 0:
            # evict the cheapest to rebuild per byte first, the oldest
            # breaking ties; stop (and reject) before displacing anything
            # priced above the candidate.  Only device residents fight:
            # host entries live under their own budget
            pool = [e for e in self._entries.values() if e.tier == "device"]
            for e in sorted(pool, key=lambda e: (e.score(self.model),
                                                 e.tick)):
                if e.key in seen:
                    continue
                if e.score(self.model) >= score:
                    break
                victims.append(e)
                need -= e.n_bytes
                if need <= 0:
                    break
            if need > 0:
                self.rejected += 1
                if self.tel.enabled:
                    self.tel.instant("cache.reject", kind=kind,
                                     reason="outpriced", n_bytes=n_bytes,
                                     score=score)
                return False
        for e in victims:
            self._evict(e, displaced_by=kind)
        self._tick += 1
        cand.tick = self._tick
        self._entries[key] = cand
        self._account_add(cand)
        self.admitted += 1
        if self.tel.enabled:
            self.tel.instant("cache.admit", kind=kind, n_bytes=n_bytes,
                             score=score)
        if interval is not None:
            self._index_locked(key, interval)
        return True

    def _index_locked(self, key, interval) -> None:
        table, column, version, lo, hi = interval
        self._intervals.setdefault(
            (table, column, int(version)), {})[key] = (int(lo), int(hi))

    def restore(self, key: Hashable, value: object, *, kind: str,
                n_bytes: int, recompute_s: float,
                tables: Iterable[str] = (),
                interval: Optional[Tuple[str, str, int, int, int]] = None,
                tenant: Optional[str] = None, hits: int = 0) -> bool:
        """The warm-start surface: re-admit a previously resident entry
        without an eviction fight (a snapshot replays into a cold cache).
        The entry lands in the host tier when the host budget holds it
        (values arrive from disk on the host anyway), else on the device
        tier if the device budget has free room.  Returns whether it was
        restored."""
        n_bytes = max(int(n_bytes), 0)
        with self._lock:
            if key in self._entries:
                return False
            if (self.host_budget_bytes > 0
                    and self.host_used_bytes + n_bytes
                    <= self.host_budget_bytes):
                tier = "host"
                value = _to_host(value)
            elif self.used_bytes + n_bytes <= self.budget_bytes:
                tier = "device"
                value = _to_device(value, self.device)
            else:
                return False
            e = CacheEntry(key, kind, value, n_bytes, float(recompute_s),
                           tuple(tables), hits=int(hits), interval=interval,
                           tenant=tenant, tier=tier)
            self._tick += 1
            e.tick = self._tick
            self._entries[key] = e
            self._account_add(e)
            self.admitted += 1
            if interval is not None:
                self._index_locked(key, interval)
            return True

    def _drop(self, e: CacheEntry) -> None:
        del self._entries[e.key]
        self._account_sub(e)
        if e.interval is not None:
            table, column, version, _, _ = e.interval
            bucket = self._intervals.get((table, column, int(version)))
            if bucket is not None:
                bucket.pop(e.key, None)
                if not bucket:
                    del self._intervals[(table, column, int(version))]

    # -- invalidation ------------------------------------------------------- #

    def invalidate_table(self, table: str) -> int:
        """Sweep every entry that depends on ``table`` (version-embedded
        keys already made them unreachable; this frees their bytes), and
        every interval bucket of the table."""
        with self._lock:
            stale = [e for e in self._entries.values() if table in e.tables]
            for e in stale:
                self._drop(e)
            self._intervals = {k: v for k, v in self._intervals.items()
                               if k[0] != table}
            self.invalidated += len(stale)
            return len(stale)

    def sync_versions(self, versions: Mapping[str, int]) -> int:
        """Cross-executor drift guard: sweep every table whose version
        moved since this cache last saw it.  Whichever executor sharing
        the cache notices a mutation first sweeps the shared entries for
        everyone."""
        swept = 0
        with self._lock:
            for table, version in versions.items():
                seen = self._seen_versions.get(table)
                if seen is not None and seen != version:
                    swept += self.invalidate_table(table)
                self._seen_versions[table] = version
        return swept

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._intervals.clear()
            self._hinted.clear()
            self._tenant_bytes.clear()
            self._tenant_bytes_host.clear()
            self.used_bytes = 0
            self.host_used_bytes = 0

    # -- reporting ---------------------------------------------------------- #

    def check_invariants(self) -> None:
        """Reconcile the running byte books against the resident entries:
        per-tier used bytes, per-tier tenant bytes and the interval index
        must be exact functions of the entries; any drift raises."""
        with self._lock:
            for tier, used, book in (
                    ("device", self.used_bytes, self._tenant_bytes),
                    ("host", self.host_used_bytes, self._tenant_bytes_host)):
                res = [e for e in self._entries.values() if e.tier == tier]
                want_used = sum(e.n_bytes for e in res)
                if used != want_used:
                    raise AssertionError(f"{tier} used_bytes drift: "
                                         f"book={used} resident={want_used}")
                want: Dict[str, int] = {}
                for e in res:
                    if e.tenant is not None:
                        want[e.tenant] = want.get(e.tenant, 0) + e.n_bytes
                if book != want:
                    raise AssertionError(
                        f"{tier} tenant byte-share drift: book={book} "
                        f"resident={want}")
            for bkey, bucket in self._intervals.items():
                for key in bucket:
                    e = self._entries.get(key)
                    if e is None or e.interval is None:
                        raise AssertionError(
                            f"interval index key {key!r} in bucket {bkey} "
                            "has no resident entry")

    def stats_dict(self) -> dict:
        with self._lock:
            self.check_invariants()
            total = self.hits + self.misses
            by_kind: Dict[str, int] = {}
            by_tier: Dict[str, int] = {}
            bytes_by_kind: Dict[str, int] = {}
            for e in self._entries.values():
                by_kind[e.kind] = by_kind.get(e.kind, 0) + 1
                by_tier[e.tier] = by_tier.get(e.tier, 0) + 1
                bytes_by_kind[e.kind] = bytes_by_kind.get(e.kind, 0) \
                    + int(e.n_bytes)
            return {
                "semantic_cache_subsumption_hits": self.subsumption_hits,
                "semantic_cache_subsumption_misses": self.subsumption_misses,
                "semantic_cache_interval_buckets": len(self._intervals),
                "semantic_cache_entries": len(self._entries),
                "semantic_cache_entries_by_kind": by_kind,
                "semantic_cache_bytes_by_kind": bytes_by_kind,
                "semantic_cache_used_bytes": self.used_bytes,
                "semantic_cache_budget_bytes": self.budget_bytes,
                "semantic_cache_entries_by_tier": by_tier,
                "semantic_cache_host_used_bytes": self.host_used_bytes,
                "semantic_cache_host_budget_bytes": self.host_budget_bytes,
                "semantic_cache_demoted": self.demoted,
                "semantic_cache_promoted": self.promoted,
                "semantic_cache_hits": self.hits,
                "semantic_cache_misses": self.misses,
                "semantic_cache_hit_rate": self.hits / total if total
                else 0.0,
                "semantic_cache_admitted": self.admitted,
                "semantic_cache_rejected": self.rejected,
                "semantic_cache_evicted": self.evicted,
                "semantic_cache_invalidated": self.invalidated,
                "semantic_cache_tenant_bytes": dict(self._tenant_bytes),
                "semantic_cache_tenant_bytes_host": dict(
                    self._tenant_bytes_host),
                "semantic_cache_tenant_caps": {
                    t: self._tenant_cap_locked(t)
                    for t in self._tenant_shares},
            }
