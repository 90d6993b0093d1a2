"""UDF registry — the MonetDB user-defined-function integration point.

The paper exposes each FPGA engine to the DBMS as a UDF started/stopped
over a register interface; here a UDF is a named python callable over
Tables, with the card-backed engine operators pre-registered.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.columnar import engine

_UDFS: dict[str, Callable] = {}


def register(name: str):
    def deco(fn: Callable) -> Callable:
        _UDFS[name] = fn
        return fn
    return deco


def call(name: str, *args, **kwargs):
    return _UDFS[name](*args, **kwargs)


def registered() -> list[str]:
    return sorted(_UDFS)


register("select_range")(engine.select_range)
register("join")(engine.join)
register("train_glm")(engine.train_glm)
register("aggregate_sum")(engine.aggregate_sum)

# declarative whole-query UDF: a logical plan through optimize->cost->exec
from repro_torch.query.exec import sql_like_query    # noqa: E402

register("sql_like_query")(sql_like_query)
