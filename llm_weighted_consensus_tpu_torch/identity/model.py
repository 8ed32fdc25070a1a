"""Panel model: 1-128 judges + panel-level weight mode and identities.

Parity target: reference src/score/model/mod.rs (429 LoC):

* ``ModelBase{llms, weight}`` -> ``into_model_validate`` (model/mod.rs:37-199):
  prepare + validate every judge, judges sorted by id for deterministic order
  (model/mod.rs:90), per-judge ``index`` / ``training_table_index`` (position
  among unique training-table ids) / ``multichat_index`` (position among
  sorted multichat ids, duplicates getting consecutive slots,
  model/mod.rs:153-178) assigned;
* panel-level ``id`` / ``training_table_id`` / ``multichat_id`` are streaming
  hashes over (weight-config JSON + sorted member ids) (model/mod.rs:97-189).
  This framework hashes each multichat id once (the reference's second hashing
  pass over the same ids, model/mod.rs:166-178, is redundant with the first
  and ids here are an independent id space anyway — see identity/__init__).
* trained-weight config ``WeightTrainingTable{embeddings:{model, max_tokens,
  provider}, top}`` (model/mod.rs:278-429).
"""

from __future__ import annotations

from typing import Optional

from ..types.base import Enum, List, Struct, TaggedUnion, _encode, field
from ..types.chat_request import ProviderPreferences
from .llm import (
    I32_MAX,
    Llm,
    LlmBase,
    _prepare_provider,
    _validate_provider,
    weight_type,
)

MAX_LLMS = 128


class PanelWeightStatic(Struct):
    type: str = field(Enum("static"), default="static")

    def prepare(self) -> None:
        pass

    def validate(self) -> None:
        pass


class WeightTrainingTableEmbeddings(Struct):
    model: str = field(str)
    max_tokens: int = field(int, default=0, skip_if_none=False)
    provider: Optional[ProviderPreferences] = field(ProviderPreferences, default=None)

    def prepare(self) -> None:
        self.provider = _prepare_provider(self.provider)

    def validate(self) -> None:
        if not self.model:
            raise ValueError("`embeddings.model` cannot be empty")
        if self.max_tokens < 0 or self.max_tokens > I32_MAX:
            raise ValueError(
                f"`embeddings.max_tokens` must be between 0 and {I32_MAX}: "
                f"got {self.max_tokens}"
            )
        _validate_provider(self.provider)


class PanelWeightTrainingTable(Struct):
    type: str = field(Enum("training_table"), default="training_table")
    embeddings: WeightTrainingTableEmbeddings = field(
        WeightTrainingTableEmbeddings, default=None
    )
    top: int = field(int, default=1, skip_if_none=False)

    def prepare(self) -> None:
        if self.embeddings is not None:
            self.embeddings.prepare()

    def validate(self) -> None:
        if self.embeddings is None:
            raise ValueError("`embeddings` is required for training table weights")
        if self.top < 1:
            raise ValueError(
                f"training table weight `top` must be at least 1: `top`={self.top}"
            )
        if self.top > I32_MAX:
            raise ValueError(
                f"training table weight `top` must be at most {I32_MAX}: `top`={self.top}"
            )
        self.embeddings.validate()


PANEL_WEIGHT = TaggedUnion(
    "type", {"static": PanelWeightStatic, "training_table": PanelWeightTrainingTable}
)

PanelWeight = (PanelWeightStatic, PanelWeightTrainingTable)


def default_panel_weight() -> PanelWeightStatic:
    return PanelWeightStatic(type="static")


class ModelBase(Struct):
    llms: list = field(List(LlmBase), default_factory=list, skip_if_none=False)
    weight: object = field(
        PANEL_WEIGHT, default_factory=default_panel_weight, skip_if_none=False
    )

    def prepare(self) -> None:
        self.weight.prepare()
        for llm in self.llms:
            llm.prepare()

    def validate_llms_len(self) -> None:
        if len(self.llms) < 1:
            raise ValueError("query model must have at least 1 llm")
        if len(self.llms) > MAX_LLMS:
            raise ValueError(
                f"query model must have at most {MAX_LLMS} llms: "
                f"llms_len={len(self.llms)}"
            )

    def into_model_validate(self) -> "Model":
        from . import IncrementalHasher
        from ..utils import jsonutil

        self.prepare()
        self.validate_llms_len()
        self.weight.validate()
        panel_weight_type = self.weight.type

        is_training_table = panel_weight_type == "training_table"

        llms: list[Llm] = []
        training_table_ids: list[str] = [] if is_training_table else None
        multichat_ids: list[str] = []

        for base in self.llms:
            base.validate(panel_weight_type)
            llm_id = base.id_string()
            training_table_id = base.training_table_id_string()
            multichat_id = base.multichat_id_string()
            if is_training_table and training_table_id is not None:
                if training_table_id not in training_table_ids:
                    training_table_ids.append(training_table_id)
            multichat_ids.append(multichat_id)
            llms.append(
                Llm(
                    id=llm_id,
                    index=0,
                    multichat_id=multichat_id,
                    multichat_index=0,
                    training_table_id=training_table_id,
                    training_table_index=None,
                    base=base,
                )
            )

        # deterministic ordering (model/mod.rs:88-94)
        llms.sort(key=lambda l: l.id)
        if training_table_ids is not None:
            training_table_ids.sort()
        multichat_ids.sort()

        # panel id: hash(weight JSON + member ids in sorted order)
        hasher = IncrementalHasher()
        hasher.write(jsonutil.dumps(_encode(PANEL_WEIGHT, self.weight)))

        tt_hasher = None
        if is_training_table:
            tt_hasher = IncrementalHasher()
            tt_hasher.write(self.weight.embeddings.to_json())

        mc_hasher = IncrementalHasher()
        multichat_seen: dict[str, int] = {}

        for i, llm in enumerate(llms):
            hasher.write(llm.id)
            llm.index = i
            if tt_hasher is not None:
                tt_hasher.write(llm.training_table_id)
                llm.training_table_index = training_table_ids.index(
                    llm.training_table_id
                )
            # duplicates of the same generator get consecutive slots
            # (model/mod.rs:153-163)
            multichat_seen[llm.multichat_id] = multichat_seen.get(llm.multichat_id, 0) + 1
            llm.multichat_index = (
                multichat_ids.index(llm.multichat_id)
                + multichat_seen[llm.multichat_id]
                - 1
            )

        for multichat_id in multichat_ids:
            mc_hasher.write(multichat_id)

        return Model(
            id=hasher.finish_id(),
            multichat_id=mc_hasher.finish_id(),
            training_table_id=tt_hasher.finish_id() if tt_hasher else None,
            llms=llms,
            weight=self.weight,
        )


class Model(Struct):
    id: str = field(str)
    multichat_id: str = field(str, default="", skip_if_none=False)
    training_table_id: Optional[str] = field(str, default=None)
    llms: list = field(List(Llm), default_factory=list, skip_if_none=False)
    weight: object = field(
        PANEL_WEIGHT, default_factory=default_panel_weight, skip_if_none=False
    )

    def static_weights(self) -> list:
        """Per-judge static weights (weight.rs:76-97)."""
        return [llm.base.weight.weight for llm in self.llms]
