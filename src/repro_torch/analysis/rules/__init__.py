"""Rule registry for the port's repro-lint (the reference's ten rules,
with their homes in ``src/repro_torch``).

Each rule is a class with an ``id`` string and a
``check(ctx: FileCtx) -> List[Violation]`` method.  Adding a rule means
writing a module here and appending the class to ``ALL_RULES``.

The ``*-protocol``/provenance/purity rules are *temporal*: they run
typestate machines from :mod:`repro_torch.analysis.protocols` over the
per-function CFGs of :mod:`repro_torch.analysis.dataflow` instead of
pattern-matching single nodes.  ``PROTOCOL_RULES`` maps their ids to the declarative machines
so the docs gate can assert the architecture table matches the code.
"""

from .trace_safety import TraceSafetyRule
from .rng_discipline import RngDisciplineRule
from .sentinel import SentinelDisciplineRule
from .dtype_discipline import DtypeDisciplineRule
from .contracts_rule import EngineContractRule
from .obs_purity import ObsPurityRule
from .effect_purity import EffectPurityRule
from .slot_protocol import SLOT_PROTOCOL, SlotProtocolRule
from .pricer_protocol import PRICER_PROTOCOL, PricerProtocolRule
from .edgebatch_provenance import EDGEBATCH_PROTOCOL, \
    EdgeBatchProvenanceRule

ALL_RULES = [
    TraceSafetyRule,
    RngDisciplineRule,
    SentinelDisciplineRule,
    DtypeDisciplineRule,
    EngineContractRule,
    ObsPurityRule,
    EffectPurityRule,
    SlotProtocolRule,
    PricerProtocolRule,
    EdgeBatchProvenanceRule,
]

#: rule id -> declarative typestate machine (docs table + replay).
PROTOCOL_RULES = {
    SLOT_PROTOCOL.rule_id: SLOT_PROTOCOL,
    PRICER_PROTOCOL.rule_id: PRICER_PROTOCOL,
    EDGEBATCH_PROTOCOL.rule_id: EDGEBATCH_PROTOCOL,
}

__all__ = ["ALL_RULES", "PROTOCOL_RULES", "TraceSafetyRule",
           "RngDisciplineRule", "SentinelDisciplineRule",
           "DtypeDisciplineRule", "EngineContractRule", "ObsPurityRule",
           "EffectPurityRule", "SlotProtocolRule", "PricerProtocolRule",
           "EdgeBatchProvenanceRule"]
