"""The paper's primary contribution, on PyTorch: qd-tree learned layouts.

Public surface:
  predicates — Schema / CutTable / predicate evaluation (numpy)
  qdtree     — Node/QdTree (construction) + FrozenQdTree (serving)
  query      — Query/Workload, tensorization, block intersection
  rewards    — C(P) skip metrics, per-node RL rewards
  greedy     — paper Algorithm 1
  routing    — torch predicate evaluation + the routing shim
  woodblock  — deep-RL construction agent (paper Sec 5), in PyTorch
"""

from repro_torch.core.predicates import (  # noqa: F401
    AdvPredicate,
    Column,
    CutTable,
    CutTableBuilder,
    Schema,
    eval_cuts,
)
from repro_torch.core.qdtree import (  # noqa: F401
    FrozenQdTree,
    IncrementalTightener,
    Node,
    NodeDesc,
    QdTree,
    TightenPartial,
    child_descs,
    root_desc,
    singleton_tree,
)
from repro_torch.core.query import (  # noqa: F401
    AdvAtom,
    InAtom,
    Query,
    RangeAtom,
    Workload,
    WorkloadTensors,
    route_query,
)
from repro_torch.core.rewards import (  # noqa: F401
    SkipStats,
    evaluate_layout,
    per_node_rewards,
    selectivity_lower_bound,
)
from repro_torch.core.greedy import GreedyConfig, build_greedy  # noqa: F401
from repro_torch.core.routing import eval_cuts_torch, route  # noqa: F401
