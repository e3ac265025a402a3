"""F-IVM core: factorized incremental view maintenance over rings.

The stream executor's durability and integrity planes live in
``repro_torch.checkpoint`` and ``repro_torch.runtime``; their entry points
are re-exported here on first use (``StreamCheckpointer``,
``IntegrityConfig``, ``StreamSupervisor``, ...), so importing the core does
not import them."""
import importlib
from .contraction import BatchedDelta, contract_dense, lift_relation, marginalize_dense
from .delta import propagate_coo, propagate_factorized
from .indicators import IndicatorState, add_indicators, gyo_residual, indicator_of, is_acyclic
from .ivm import IVMEngine, canonical_state
from .materialize import choose_materialized, gather_scatter_profile, views_on_path
from .plan import PlanCache, TriggerPlan, compile_trigger, execute_trigger
from .query import Query
from .relations import COOUpdate, DenseRelation, FactorizedUpdate, PyRelation
from .shard import (
    ShardPlan,
    ShardSpec,
    make_mesh,
    plan_shards,
    replan_shards,
    shard_executor,
)
from .py_engine import PyEngineSpec, PyIVM
from .rings import (DegreeMRing, MulTerm, PyDegreeMRing, PyNumberRing,
                    PyRelationalRing, PyRing, Ring, ScalarRing, count_ring,
                    sum_ring)
from .storage import (SparseRelation, StorageSpec, ViewStorage,
                      apply_storage_plan, as_dense, make_base_relation,
                      plan_storage, view_nbytes)
from .stream import (MAX_ROUNDS_PERIOD, PreparedStream, StreamCapacityError,
                     StreamExecutor, capacity_segments, check_stream_capacity,
                     prepare_stream, split_segments)
from .variable_orders import VariableOrder, VONode, chain, heuristic_order
from .view_tree import ViewNode, build_view_tree, evaluate_view

__all__ = [
    "BatchedDelta", "COOUpdate", "DegreeMRing", "DenseRelation",
    "FactorizedUpdate", "IVMEngine", "IndicatorState",
    "MAX_ROUNDS_PERIOD", "MulTerm", "PlanCache", "PreparedStream",
    "PyDegreeMRing", "PyEngineSpec", "PyIVM", "PyNumberRing", "PyRelation",
    "PyRelationalRing", "PyRing", "Query",
    "Ring", "ScalarRing", "ShardPlan", "ShardSpec", "SparseRelation",
    "StorageSpec", "StreamCapacityError",
    "StreamExecutor", "TriggerPlan", "VONode", "VariableOrder", "ViewNode",
    "ViewStorage", "add_indicators", "apply_storage_plan", "as_dense",
    "build_view_tree", "canonical_state",
    "capacity_segments", "chain", "check_stream_capacity",
    "choose_materialized", "compile_trigger", "contract_dense", "count_ring",
    "evaluate_view", "execute_trigger", "gather_scatter_profile",
    "gyo_residual", "heuristic_order", "indicator_of", "is_acyclic",
    "lift_relation", "make_base_relation", "make_mesh", "marginalize_dense",
    "plan_shards", "plan_storage", "prepare_stream", "propagate_coo",
    "propagate_factorized", "replan_shards", "shard_executor",
    "split_segments", "sum_ring",
    "view_nbytes", "views_on_path",
]

#: entry points of the durability and integrity planes, by defining module
_PLANES = {
    "Checkpointer": "repro_torch.checkpoint.checkpointer",
    "StreamCheckpointer": "repro_torch.checkpoint.stream_state",
    "DeadLetterLog": "repro_torch.runtime.integrity",
    "IntegrityConfig": "repro_torch.runtime.integrity",
    "StreamIntegrityError": "repro_torch.runtime.integrity",
    "StragglerMonitor": "repro_torch.runtime.fault_tolerance",
    "StreamSupervisor": "repro_torch.runtime.fault_tolerance",
}
__all__ += sorted(_PLANES)


def __getattr__(name: str):
    if name in _PLANES:
        return getattr(importlib.import_module(_PLANES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
