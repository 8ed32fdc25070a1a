"""Per-judge weight resolution: static config or trained training-table.

Parity target: reference src/score/completions/weight.rs — the ``Fetchers``
dispatch (40-64), ``StaticFetcher`` (76-97), and the training-table seam
(5-18, 99-117) whose ``TrainingTableData.embeddings_response`` evidence is
echoed in responses as ``weight_data`` and whose usage seeds cost accounting
(score client.rs:330-337).

The port's copy of ``llm_weighted_consensus_tpu/weights/__init__.py``.  The
trained-weight path on the card (embed the prompt, cosine top-k lookup per
judge, interpolate within [min, max]) is
``weights.training_table.TorchTrainingTableFetcher`` and plugs in here.
"""

from __future__ import annotations

from typing import Tuple

from ..errors import ResponseError
from ..types.score_response import StaticData, TrainingTableData


class StaticWeightFetcher:
    """Read per-judge static weights straight from panel config."""

    async def fetch(self, ctx, request, model) -> Tuple[list, StaticData]:
        return model.static_weights(), StaticData()


class TrainingTableWeightFetcher:
    """Seam: resolve per-judge weights from trained tables.

    Implementations return (weights, TrainingTableData) where the data
    carries the embeddings_response evidence.  The device-backed
    implementation is ``weights.training_table.TorchTrainingTableFetcher``.
    """

    async def fetch(self, ctx, request, model) -> Tuple[list, TrainingTableData]:
        raise NotImplementedError


class UnimplementedTrainingTableFetcher(TrainingTableWeightFetcher):
    async def fetch(self, ctx, request, model):
        raise ResponseError(
            code=501, message="training-table weight fetcher not configured"
        )


class WeightFetchers:
    """Dispatch on the panel's weight mode (weight.rs:40-64)."""

    def __init__(
        self,
        static_fetcher: StaticWeightFetcher = None,
        training_table_fetcher: TrainingTableWeightFetcher = None,
    ) -> None:
        self.static = static_fetcher or StaticWeightFetcher()
        self.training_table = (
            training_table_fetcher or UnimplementedTrainingTableFetcher()
        )

    async def fetch(self, ctx, request, model):
        """Returns (weights: list[Decimal], data: StaticData|TrainingTableData)."""
        if model.weight.type == "static":
            return await self.static.fetch(ctx, request, model)
        return await self.training_table.fetch(ctx, request, model)
