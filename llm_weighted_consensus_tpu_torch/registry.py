"""Model registry seam: stored panels addressable by 22-char content id.

Parity target: reference src/score/model/fetcher.rs (trait + unimplemented
stub).  ``InMemoryModelRegistry`` adds the obvious store the reference leaves
external: panels registered by their content-addressed id.
"""

from __future__ import annotations

from .errors import ResponseError


class ModelFetcher:
    async def fetch(self, ctx, model_id: str):
        """Return a validated ``identity.model.Model`` or raise ResponseError."""
        raise NotImplementedError


class UnimplementedModelFetcher(ModelFetcher):
    async def fetch(self, ctx, model_id: str):
        raise ResponseError(code=501, message="model registry not configured")


class InMemoryModelRegistry(ModelFetcher):
    def __init__(self) -> None:
        self._models: dict = {}

    def put(self, model) -> str:
        """Register a validated Model under its content id."""
        self._models[model.id] = model
        return model.id

    async def fetch(self, ctx, model_id: str):
        model = self._models.get(model_id)
        if model is None:
            raise ResponseError(code=404, message=f"model not found: {model_id}")
        return model
