"""Runtime planes of the stream executor (PyTorch port of ``repro.runtime``):
deterministic fault injection (:mod:`.faults`), the integrity layer
(:mod:`.integrity`: validated admission, quarantine, audited Reevaluate)
and supervision (:mod:`.fault_tolerance`: ``StreamSupervisor``'s escalation
ladder, straggler monitoring, elastic membership)."""
