"""MCU export compiler for the port's quantized CapsNets, the
counterpart of the reference's `repro.edge`:

QuantCapsNet -> lower() -> EdgeProgram -> { plan_arena() memory plan,
EdgeVM bit-exact execution, emit_c() CMSIS-NN-style sources,
save()/load() single-file artifact, to_qnet()/load_qnet() back into a
servable net on the card }.

Every file it writes is byte-identical to what the reference writes for
the same net, and an artifact written by either package loads in both.
"""
from repro_torch.edge.arena import (ArenaPlan, assign_offsets,
                                    format_report, lifetimes, memory_report,
                                    op_scratch_bytes, plan_arena)
from repro_torch.edge.costmodel import (MCU_PROFILES, McuProfile,
                                        estimate_all, estimate_program,
                                        format_estimate, format_estimates,
                                        get_profile, total_latency_ms)
from repro_torch.edge.emit_c import emit_c, save_c
from repro_torch.edge.export import export_artifacts, format_export
from repro_torch.edge.importer import load_qnet, program_config, to_qnet
from repro_torch.edge.lower import describe, lower
from repro_torch.edge.program import EdgeOp, EdgeProgram, TensorSpec
from repro_torch.edge.vm import EdgeVM, execute

__all__ = ["MCU_PROFILES", "ArenaPlan", "EdgeOp", "EdgeProgram", "EdgeVM",
           "McuProfile", "TensorSpec", "assign_offsets", "describe",
           "emit_c", "estimate_all", "estimate_program", "execute",
           "export_artifacts", "format_estimate", "format_estimates",
           "format_export", "format_report", "get_profile", "lifetimes",
           "load_qnet", "lower", "memory_report", "op_scratch_bytes",
           "plan_arena", "program_config", "save_c", "to_qnet",
           "total_latency_ms"]
