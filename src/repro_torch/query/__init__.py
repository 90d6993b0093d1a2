"""Query subsystem of the port: logical plans -> optimizer -> cost model ->
physical executor (batch / stream / eager), with telemetry, the semantic
cache and its warm-start persistence, and the query server in front.

    from repro_torch.query import Q, Catalog, Executor

    cat = Catalog.from_tables(lineitem, orders)        # on the card
    ex = Executor(cat)
    q = (Q.scan("lineitem").filter("quantity", 30, 49)
          .join(Q.scan("orders"), on="orderkey").sum("price"))
    total = ex.execute(q).value

    cached = Executor(cat, cache_bytes=1 << 30)        # opt-in semantic cache
    persist.save_state("snap.npz", cached.cache,
                       cost_model=cached.cost_model,
                       table_versions=cat.versions())

    srv = QueryServer(Executor(cat, cache_bytes=1 << 30), streaming=True,
                      morsel_rows=1 << 22, policy=AdaptivePolicy(),
                      persist_path="server.npz")
    srv.register_tenant(TenantSpec("dash", priority=10, slo_p95_s=0.05))
    qid = srv.submit(q, tenant="dash")
    results = srv.drain()                    # qid -> value
    srv.save_state()
"""
from repro_torch.query.logical import (                          # noqa: F401
    Aggregate, Filter, FilterProject, HyperParams, Join, Node, Project, Q,
    Scan, SelectionInterval, canonicalize, fingerprint, literals,
    output_columns, pformat, selection_interval, signature,
    subsumption_key, tables_of, walk,
)
from repro_torch.query.cost import (                             # noqa: F401
    TIERS, ColumnStats, CostModel, PhysNode, TableStats, column_placements,
    estimate_rows, join_orientation_cost, key_is_unique, load_calibration,
    plan_physical,
)
from repro_torch.query.optimize import (                         # noqa: F401
    choose_build_side, common_subplans, fuse_filter_project, optimize,
    prune_columns, push_down_filters,
)
from repro_torch.query.pipeline import (                         # noqa: F401
    BreakerSpec, CompiledPipeline, ProjectStreamPlan, StreamPlan, analyze,
    analyze_project,
)
from repro_torch.query.tiering import (                          # noqa: F401
    SpillPlan, TierBudgets, plan_spill,
)
from repro_torch.query.telemetry import (                        # noqa: F401
    BandwidthLedger, MetricsRegistry, Telemetry,
)
from repro_torch.query.cache import (                            # noqa: F401
    SemanticCache, cache_disabled,
)
from repro_torch.query import persist                            # noqa: F401
from repro_torch.query.exec import (                             # noqa: F401
    Catalog, Executor, PlacementCapacityError, Result, sql_like_query,
)
from repro_torch.query.serve import (                            # noqa: F401
    AdaptivePolicy, QueryRecord, QueryServer, TenantSpec,
)
