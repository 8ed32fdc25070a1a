"""The archive's side of the port's server: the archiving client wrapper,
``POST /archive/rescore`` and ``POST /weights/learn``.

Counterpart of ``_ArchivingClient``, ``_rescore_handler`` and
``_learn_handler`` in ``llm_weighted_consensus_tpu/serve/__main__.py``,
with the same request bodies, responses and 400s.  The two handlers are
coroutines on the chat routes' one event loop (``serve/chat_routes.py``
``ChatRoutes.add_json_route``): a handler thread submits the raw body
and writes back the (status, body) the coroutine returns.

* ``POST /archive/rescore`` — body (all optional) ``{"weight_overrides":
  {judge id: number}, "ids": [completion ids], "revote": bool,
  "apply": bool, "include_results": bool}`` -> ``{"rescored": N,
  "applied": N, "results"?: {id: {"weight": [...], "confidence":
  [...]}}}``.  The device work (``archive.rescore.rescore_archive``) runs
  in the loop's executor without the lock: it reads only judge votes and
  weights, which no other writer touches.  ``apply`` then writes the
  results back on the loop thread, under the lock it shares with
  learning, so no request on the loop sees a half-applied completion
  (weight updated, confidence not);
* ``POST /weights/learn`` — body ``{"model": <inline panel>, "labels"?:
  {completion id: candidate index}, "ids"?: [completion ids]}`` ->
  ``{"rows_added": N}``: ``weights.learning.populate_from_archive`` in
  the executor (it embeds the prompts on the embedder's device), under
  the lock, so two learning passes cannot both pass the idempotence
  check before either marks.
"""

from __future__ import annotations

import asyncio
import json
import logging
from decimal import Decimal

from .. import obs
from ..utils import jsonutil
from .chat_routes import parse_error_response

log = logging.getLogger("lwc.torch.serve")


class ArchivingClient:
    """Wraps a client so every served UNARY completion is archived (its id
    becomes referenceable by later requests); everything else delegates.
    ``put(result, params)`` receives the request too: the score path
    archives it beside the completion, feeding training-table learning
    (``weights/learning.py``).

    Streaming: by default streamed responses are not archived.  With
    ``stream_fold`` set (``ARCHIVE_STREAMING=1``), the chunk stream is
    teed into the merge algebra (each chunk ``push``ed into a running
    aggregate) and the folded unary is archived at the stream's clean
    end.  A stream the client abandons, or one that carries an error
    item, archives nothing (a partial fold would look complete), and the
    fold never breaks the client's stream."""

    def __init__(self, inner, put, stream_fold=None):
        self._inner = inner
        self._put = put
        self._stream_fold = stream_fold

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def create_unary(self, ctx, params):
        result = await self._inner.create_unary(ctx, params)
        self._put(result, params)
        return result

    async def create_streaming(self, ctx, params):
        stream = await self._inner.create_streaming(ctx, params)
        if self._stream_fold is None:
            return stream
        return self._tee(stream, params)

    async def _tee(self, stream, params):
        aggregate = None
        foldable = True
        completed = False
        try:
            async for chunk in stream:
                # the fold is a side channel: an error item or a failing
                # clone/push poisons it (nothing is archived) while every
                # chunk still reaches the client
                if foldable:
                    try:
                        if isinstance(chunk, Exception):
                            foldable = False
                        elif aggregate is None:
                            aggregate = chunk.clone()
                        else:
                            aggregate.push(chunk)
                    except Exception:
                        foldable = False
                        aggregate = None
                yield chunk
            completed = True
        finally:
            # a client disconnect surfaces here (GeneratorExit or a
            # cancellation): close the upstream stream promptly
            aclose = getattr(stream, "aclose", None)
            if aclose is not None:
                await aclose()
        if completed and foldable and aggregate is not None:
            try:
                self._put(self._stream_fold(aggregate), params)
            except Exception:
                log.warning(
                    "streamed completion could not be archived "
                    "(fold/store failure); the response was served intact",
                    exc_info=True,
                )


def archiving_clients(store, config, chat, multichat, score) -> tuple:
    """(chat, multichat, score) wrapped to archive what they serve into
    ``store`` (``ARCHIVE_WRITE``; streams too under ``ARCHIVE_STREAMING``);
    a score completion is stored with its request."""
    from ..types import chat_response, multichat_response, score_response

    def put_score(result, params):
        store.put_score(result)
        store.put_score_request(result.id, params)

    def fold(unary_cls):
        return unary_cls.from_streaming if config.archive_streaming else None

    return (
        ArchivingClient(chat, lambda result, params: store.put_chat(result),
                        fold(chat_response.ChatCompletion)),
        ArchivingClient(
            multichat, lambda result, params: store.put_multichat(result),
            fold(multichat_response.ChatCompletion)),
        ArchivingClient(score, put_score,
                        fold(score_response.ChatCompletion)),
    )


def _json(status: int, obj) -> tuple:
    return status, jsonutil.dumps(obj).encode()


def rescore_handler(store, lock: asyncio.Lock, device=None):
    """The ``POST /archive/rescore`` coroutine (see module doc):
    raw body -> (status, body bytes)."""
    from ..archive.rescore import apply_rescore, rescore_archive

    def bad_request(message):
        return _json(400, {"code": 400, "message": message})

    async def handler(raw: bytes):
        try:
            body = jsonutil.loads(raw.decode("utf-8") or "{}")
            if not isinstance(body, dict):
                return bad_request("body must be a JSON object")
            oraw = body.get("weight_overrides") or {}
            if not isinstance(oraw, dict):
                raise ValueError(
                    "`weight_overrides` must map judge ids to numbers"
                )
            overrides = {}
            for judge, w in oraw.items():
                if isinstance(w, bool) or not isinstance(
                    w, (int, float, Decimal)
                ):
                    raise ValueError(
                        f"`weight_overrides[{judge!r}]` must be a number"
                    )
                overrides[str(judge)] = float(w)
            ids = body.get("ids")
            revote = bool(body.get("revote", False))
            apply = bool(body.get("apply", False))
            include = bool(body.get("include_results", False))
        except Exception as e:  # the parse phase: malformed input
            return parse_error_response(e)
        # validation past parsing stays outside the blanket except: a
        # store fault surfaces as a 500, not as a 400
        if ids is not None:
            if not isinstance(ids, list):
                return bad_request("`ids` must be a list")
            unknown = [
                cid for cid in ids if store.score_completion(cid) is None
            ]
            if unknown:
                return bad_request(
                    f"unknown score completion ids: {unknown[:5]}"
                )

        def run():
            return rescore_archive(
                store, weight_overrides=overrides or None, ids=ids,
                revote=revote, device=device,
            )

        # the executor thread has no ambient context: carry the span
        results = await asyncio.get_running_loop().run_in_executor(
            None, obs.carry(run))
        applied = 0
        if apply:
            # on the loop and locked: atomic for the loop's readers,
            # serialized against learning
            async with lock:
                applied = apply_rescore(store, results)
        out = {"rescored": len(results), "applied": applied}
        if include:
            out["results"] = results
        return _json(200, out)

    return handler


def learn_handler(store, embedder, tables, lock: asyncio.Lock):
    """The ``POST /weights/learn`` coroutine (see module doc): raw body
    -> (status, body bytes)."""
    from ..identity.model import ModelBase
    from ..weights.learning import populate_from_archive

    async def handler(raw: bytes):
        try:
            body = jsonutil.loads(raw.decode("utf-8"))
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
            if "model" not in body:
                raise ValueError("missing required field `model`")
            model = ModelBase.from_json_obj(
                body["model"]
            ).into_model_validate()
            lraw = body.get("labels") or {}
            if not isinstance(lraw, dict):
                raise ValueError(
                    "`labels` must map completion ids to candidate indexes"
                )
            labels = {}
            for cid, idx in lraw.items():
                if isinstance(idx, bool) or not isinstance(idx, int):
                    raise ValueError(
                        f"`labels[{cid!r}]` must be an integer index"
                    )
                labels[str(cid)] = int(idx)
            ids = body.get("ids")
        except Exception as e:  # the parse phase: malformed input
            return parse_error_response(e)
        async with lock:
            added = await asyncio.get_running_loop().run_in_executor(
                None,
                obs.carry(lambda: populate_from_archive(
                    store, embedder, model, tables, ids=ids, labels=labels
                )),
            )
        # the reference answers through aiohttp's json_response
        # (``json.dumps``, default separators)
        return 200, json.dumps({"rows_added": added}).encode()

    return handler
