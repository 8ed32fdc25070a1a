"""Judge (LLM) configuration: canonicalization, validation, 3-way identity.

Parity target: reference src/score/llm/mod.rs (745 LoC):

* ``prepare`` (llm/mod.rs:76-258) canonicalizes the config *before hashing* so
  semantically-equal configs hash equal (drop fields equal to defaults, sort
  provider string lists, collapse singleton ``stop`` arrays, ...);
* ``validate`` (llm/mod.rs:260-511) enforces ranges;
* three content-addressed identities (llm/mod.rs:513-548):
  - ``id``                — full config,
  - ``training_table_id`` — weight reset to default (judges sharing a training
                            table row regardless of weight bounds),
  - ``multichat_id``      — weight/output_mode/synthetic_reasoning/top_logprobs
                            reset (judges that are the same *generator*).

The default weight (static 1.0) participates in hashing and is frozen, same
as the reference's ``NEVER change this implementation`` guard
(llm/mod.rs:597-605).
"""

from __future__ import annotations

from decimal import Decimal
from typing import Optional

from ..types.base import (
    Map,
    Struct,
    TaggedUnion,
    field,
)
from ..types.chat_request import (
    MESSAGE,
    ProviderPreferences,
    REASONING_EFFORT,
    Reasoning,
    STOP,
    VERBOSITY,
)
from ..types.base import Enum, List

OUTPUT_MODE = Enum("instruction", "json_schema", "tool_call")
OUTPUT_MODE_DEFAULT = "instruction"

MAX_TOP_LOGPROBS = 20
I32_MAX = 2**31 - 1


class WeightStatic(Struct):
    type: str = field(Enum("static"), default="static")
    weight: Decimal = field(Decimal, default_factory=lambda: Decimal("1.0"))

    def validate(self) -> None:
        if not self.weight.is_finite() or self.weight <= 0:
            raise ValueError(
                f"`weight` must be a normal positive number: `weight`={self.weight}"
            )


class WeightTrainingTable(Struct):
    type: str = field(Enum("training_table"), default="training_table")
    base_weight: Decimal = field(Decimal, default_factory=lambda: Decimal("1.0"))
    min_weight: Decimal = field(Decimal, default_factory=lambda: Decimal("1.0"))
    max_weight: Decimal = field(Decimal, default_factory=lambda: Decimal("1.0"))

    def validate(self) -> None:
        if (
            not self.base_weight.is_finite()
            or not self.min_weight.is_finite()
            or not self.max_weight.is_finite()
            or self.base_weight < self.min_weight
            or self.base_weight > self.max_weight
            or self.min_weight > self.max_weight
            or self.base_weight <= 0
            or self.min_weight <= 0
            or self.max_weight <= 0
        ):
            raise ValueError(
                "LLM must have normal positive base, min, and max weights for "
                "training table weights mode: "
                f"`base_weight={self.base_weight}`, `min_weight={self.min_weight}`, "
                f"`max_weight={self.max_weight}`"
            )


# Weight is untagged in serde but fully determined by its `type` value, so a
# tagged union reproduces the same JSON (llm/mod.rs:590-605).
WEIGHT = TaggedUnion(
    "type", {"static": WeightStatic, "training_table": WeightTrainingTable}
)

Weight = (WeightStatic, WeightTrainingTable)


def default_weight() -> WeightStatic:
    # NEVER change: participates in id hashing (llm/mod.rs:597-605).
    return WeightStatic(type="static", weight=Decimal("1.0"))


def weight_type(weight) -> str:
    return weight.type


def _validate_range_f(value, name, lo, hi):
    if value is None:
        return
    import math

    if not math.isfinite(value):
        raise ValueError(f"`{name}` must be a finite number: `{name}`={value}")
    if value < lo or value > hi:
        raise ValueError(
            f"`{name}` must be between {lo} and {hi}: `{name}`={value}"
        )


def _validate_range_u(value, name, lo, hi):
    if value is None:
        return
    if value < lo or value > hi:
        raise ValueError(
            f"`{name}` must be between {lo} and {hi}: `{name}`={value}"
        )


def _validate_strings(values, name):
    if values is None:
        return
    seen = set()
    for s in values:
        if s == "":
            raise ValueError(f"`{name}` cannot contain empty strings")
        if s in seen:
            raise ValueError(f"`{name}` cannot contain duplicate strings: `{s}`")
        seen.add(s)


def _prepare_provider(provider: Optional[ProviderPreferences]):
    """Canonicalize provider preferences (llm/mod.rs:158-207)."""
    if provider is None:
        return None
    if provider.is_empty():
        return None
    if provider.order is not None and not provider.order:
        provider.order = None
    if provider.allow_fallbacks is True:
        provider.allow_fallbacks = None
    if provider.require_parameters is False:
        provider.require_parameters = None
    if provider.data_collection == "allow":
        provider.data_collection = None
    for attr in ("only", "ignore", "quantizations"):
        values = getattr(provider, attr)
        if values is not None:
            values.sort()
            if not values:
                setattr(provider, attr, None)
    if provider.is_empty():
        return None
    return provider


def _validate_provider(provider: Optional[ProviderPreferences]):
    if provider is None:
        return
    _validate_strings(provider.order, "provider.order")
    _validate_strings(provider.only, "provider.only")
    _validate_strings(provider.ignore, "provider.ignore")
    _validate_strings(provider.quantizations, "provider.quantizations")
    if provider.sort is not None and provider.sort == "":
        raise ValueError("`provider.sort` cannot be empty")


class LlmBase(Struct):
    """Per-judge config (llm/mod.rs:7-73); field order is hash-significant."""

    model: str = field(str)
    weight: object = field(WEIGHT, default_factory=default_weight, skip_if_none=False)
    output_mode: str = field(OUTPUT_MODE, default=OUTPUT_MODE_DEFAULT, skip_if_none=False)
    synthetic_reasoning: Optional[bool] = field(bool, default=None)
    top_logprobs: Optional[int] = field(int, default=None)
    prefix_messages: Optional[list] = field(List(MESSAGE), default=None)
    suffix_messages: Optional[list] = field(List(MESSAGE), default=None)
    # openai fields
    frequency_penalty: Optional[float] = field(float, default=None)
    logit_bias: Optional[dict] = field(Map(int), default=None)
    max_completion_tokens: Optional[int] = field(int, default=None)
    presence_penalty: Optional[float] = field(float, default=None)
    stop: object = field(STOP, default=None)
    temperature: Optional[float] = field(float, default=None)
    top_p: Optional[float] = field(float, default=None)
    # openrouter fields
    max_tokens: Optional[int] = field(int, default=None)
    min_p: Optional[float] = field(float, default=None)
    provider: Optional[ProviderPreferences] = field(ProviderPreferences, default=None)
    reasoning: Optional[Reasoning] = field(Reasoning, default=None)
    repetition_penalty: Optional[float] = field(float, default=None)
    top_a: Optional[float] = field(float, default=None)
    top_k: Optional[int] = field(int, default=None)
    verbosity: Optional[str] = field(VERBOSITY, default=None)
    models: Optional[list] = field(List(str), default=None)

    # -- canonicalization (llm/mod.rs:76-258) -------------------------------

    def prepare(self) -> None:
        def drop_default(attr, default):
            if getattr(self, attr) == default:
                setattr(self, attr, None)

        if self.synthetic_reasoning is False:
            self.synthetic_reasoning = None
        if self.top_logprobs == 0:
            self.top_logprobs = None
        if self.prefix_messages is not None and not self.prefix_messages:
            self.prefix_messages = None
        if self.suffix_messages is not None and not self.suffix_messages:
            self.suffix_messages = None
        drop_default("frequency_penalty", 0.0)
        if self.logit_bias is not None and not self.logit_bias:
            self.logit_bias = None
        drop_default("max_completion_tokens", 0)
        drop_default("presence_penalty", 0.0)
        # stop: [] -> None, [x] -> x, else sorted
        if isinstance(self.stop, list):
            if not self.stop:
                self.stop = None
            elif len(self.stop) == 1:
                self.stop = self.stop[0]
            else:
                self.stop.sort()
        drop_default("temperature", 1.0)
        drop_default("top_p", 1.0)
        drop_default("max_tokens", 0)
        drop_default("min_p", 0.0)
        self.provider = _prepare_provider(self.provider)
        self._prepare_reasoning()
        drop_default("repetition_penalty", 1.0)
        drop_default("top_a", 0.0)
        drop_default("top_k", 0)
        if self.verbosity == "medium":
            self.verbosity = None
        if self.models is not None and not self.models:
            self.models = None

    def _prepare_reasoning(self) -> None:
        r = self.reasoning
        if r is None:
            return
        if r.max_tokens == 0:
            r.max_tokens = None
        if r.enabled is True and (r.effort is not None or r.max_tokens is not None):
            r.enabled = None
        elif r.enabled is False and r.effort is None and r.max_tokens is None:
            r.enabled = None
        if r.max_tokens is None and r.enabled is None and r.effort is None:
            self.reasoning = None

    # -- validation (llm/mod.rs:260-511) ------------------------------------

    def validate(self, expect_weight_type: str) -> None:
        if not self.model:
            raise ValueError("`model` cannot be empty")
        if weight_type(self.weight) != expect_weight_type:
            raise ValueError(
                f"expected weight of type `{expect_weight_type}`, "
                f"found `{weight_type(self.weight)}`"
            )
        self.weight.validate()
        if self.synthetic_reasoning and self.output_mode == "instruction":
            raise ValueError(
                "`synthetic_reasoning` cannot be true when `output_mode` is `instruction`"
            )
        _validate_range_u(self.top_logprobs, "top_logprobs", 0, MAX_TOP_LOGPROBS)
        _validate_range_f(self.frequency_penalty, "frequency_penalty", -2.0, 2.0)
        self._validate_logit_bias()
        _validate_range_u(
            self.max_completion_tokens, "max_completion_tokens", 0, I32_MAX
        )
        _validate_range_f(self.presence_penalty, "presence_penalty", -2.0, 2.0)
        self._validate_stop()
        _validate_range_f(self.temperature, "temperature", 0.0, 2.0)
        _validate_range_f(self.top_p, "top_p", 0.0, 1.0)
        _validate_range_u(self.max_tokens, "max_tokens", 0, I32_MAX)
        _validate_range_f(self.min_p, "min_p", 0.0, 1.0)
        _validate_provider(self.provider)
        self._validate_reasoning()
        _validate_range_f(self.repetition_penalty, "repetition_penalty", 0.0, 2.0)
        _validate_range_f(self.top_a, "top_a", 0.0, 1.0)
        _validate_range_u(self.top_k, "top_k", 0, I32_MAX)
        self._validate_models()

    def _validate_logit_bias(self) -> None:
        if self.logit_bias is None:
            return
        for token, bias in self.logit_bias.items():
            if token == "":
                raise ValueError("`logit_bias` keys cannot be empty")
            if not token.isdigit():
                raise ValueError(
                    f"`logit_bias` keys must be numeric: `logit_bias`={token}"
                )
            if token[0] == "0" and len(token) > 1:
                raise ValueError(
                    f"`logit_bias` keys cannot have leading zeroes: `logit_bias`={token}"
                )
            if bias > 100 or bias < -100:
                raise ValueError(
                    "`logit_bias` values must be between -100 and 100: "
                    f"`logit_bias[{token}]`={bias}"
                )

    def _validate_stop(self) -> None:
        if self.stop is None:
            return
        if isinstance(self.stop, str):
            if self.stop == "":
                raise ValueError("`stop` cannot be an empty string")
        else:
            _validate_strings(self.stop, "stop")

    def _validate_reasoning(self) -> None:
        r = self.reasoning
        if r is None:
            return
        _validate_range_u(r.max_tokens, "reasoning.max_tokens", 0, I32_MAX)
        if r.effort is not None and r.max_tokens is not None:
            raise ValueError(
                "`reasoning.max_tokens` and `reasoning.effort` cannot be set at the same time"
            )
        if r.enabled is False and r.max_tokens is not None:
            raise ValueError(
                "`reasoning.enabled` cannot be false when `reasoning.max_tokens` is set"
            )
        if r.enabled is False and r.effort is not None:
            raise ValueError(
                "`reasoning.enabled` cannot be false when `reasoning.effort` is set"
            )

    def _validate_models(self) -> None:
        if self.models is None:
            return
        seen = set()
        for model in self.models:
            if model == "":
                raise ValueError("models cannot contain empty strings")
            if model == self.model or model in seen:
                raise ValueError(
                    f"models cannot contain duplicate strings: `models`={model}"
                )
            seen.add(model)

    # -- identity (llm/mod.rs:513-548) --------------------------------------

    def id_number(self) -> int:
        from . import hash_json_obj

        return hash_json_obj(self.to_json_obj())

    def id_string(self) -> str:
        from . import id_string

        return id_string(self.id_number())

    def training_table_id_string(self) -> Optional[str]:
        if weight_type(self.weight) != "training_table":
            return None
        clone = self.clone()
        clone.weight = default_weight()
        return clone.id_string()

    def multichat_id_string(self) -> str:
        clone = self.clone()
        clone.weight = default_weight()
        clone.output_mode = OUTPUT_MODE_DEFAULT
        clone.synthetic_reasoning = None
        clone.top_logprobs = None
        return clone.id_string()

    # -- conversion ---------------------------------------------------------

    def into_llm_without_indices(self) -> "LlmWithoutIndices":
        self.prepare()
        self.validate(weight_type(self.weight))
        return LlmWithoutIndices(
            id=self.id_string(),
            multichat_id=self.multichat_id_string(),
            training_table_id=self.training_table_id_string(),
            base=self,
        )


class _FlattenedLlm(Struct):
    """Shared flatten(base) serialization for Llm/LlmWithoutIndices."""

    def to_json_obj(self):
        out = super().to_json_obj()
        out.update(out.pop("base", {}) or {})
        return out

    @classmethod
    def from_json_obj(cls, obj, *, path: str = ""):
        import dataclasses

        own = {f.metadata.get("json_name") or f.name for f in dataclasses.fields(cls)}
        own.discard("base")
        top = {k: v for k, v in obj.items() if k in own}
        rest = {k: v for k, v in obj.items() if k not in own}
        top["base"] = rest
        return super().from_json_obj(top, path=path)


class LlmWithoutIndices(_FlattenedLlm):
    id: str = field(str)
    multichat_id: str = field(str)
    training_table_id: Optional[str] = field(str, default=None)
    base: LlmBase = field(LlmBase, default=None)


class Llm(_FlattenedLlm):
    """Validated judge with panel indices (llm/mod.rs:720-745)."""

    id: str = field(str)
    index: int = field(int, default=0, skip_if_none=False)
    multichat_id: str = field(str, default="", skip_if_none=False)
    multichat_index: int = field(int, default=0, skip_if_none=False)
    training_table_id: Optional[str] = field(str, default=None)
    training_table_index: Optional[int] = field(int, default=None)
    base: LlmBase = field(LlmBase, default=None)
