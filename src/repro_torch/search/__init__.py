"""repro_torch.search — accuracy-driven quantization & variant search,
the port of the reference's `repro.search`.

Q-CapsNets-style design-space exploration over the typed PipelinePlan:
per-layer Qm.n frac reductions, per-channel/per-out weight formats, and
operator-variant selection, scored on accuracy x memory x estimated MCU
latency x numerics health, producing a *verified* Pareto frontier
(every point exports/re-imports/bit-verifies as `.capsbin`).  See
src/repro_torch/search/README.md for the module contract and how the
port differs (device and backend).
"""
from repro_torch.search.driver import (SearchConfig, model_config,
                                       run_search, save_doc, setup_space)
from repro_torch.search.frontier import (AXES, SEARCH_SCHEMA, build_doc,
                                         dominated_pairs, dominates,
                                         frontier_table_rows, load_doc,
                                         pareto, rebuild_point, verify_point)
from repro_torch.search.objective import (Candidate, Objective,
                                          flash_packed_bytes)
from repro_torch.search.space import (MAX_REDUCTION, CandidateSpec,
                                      SearchSpace)
from repro_torch.search.strategies import STRATEGIES

__all__ = [
    "AXES", "Candidate", "CandidateSpec", "MAX_REDUCTION", "Objective",
    "SEARCH_SCHEMA", "STRATEGIES", "SearchConfig", "SearchSpace",
    "build_doc", "dominated_pairs", "dominates", "flash_packed_bytes",
    "frontier_table_rows", "load_doc", "model_config", "pareto",
    "rebuild_point", "run_search", "save_doc", "setup_space",
    "verify_point",
]
