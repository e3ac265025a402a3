"""Static analysis over the compiled maintenance artifacts (PyTorch port of
``repro.analysis``).

``repro_torch.analysis.verifier`` re-derives every maintenance invariant the
runtime subsystems assume — schema and dataflow typing, write / read races,
fusion legality on the H100, capacity soundness — directly from the
trigger-plan IR and reports disagreements as structured
:class:`PlanViolation` records.
"""
from .verifier import (  # noqa: F401
    VERIFY_ENV_VAR,
    VERIFY_MODES,
    PlanVerificationError,
    PlanViolation,
    check_plan,
    check_shard,
    check_step,
    commutativity_witness,
    set_verify,
    use_verify,
    verify_mode,
    verify_shard_plan,
    verify_step_plans,
    verify_trigger_plan,
)
