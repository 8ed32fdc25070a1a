"""IO shells: the upstream chat client and the multichat fan-out.

The port's copy of ``llm_weighted_consensus_tpu/clients`` for the chat
and multichat routes (asyncio; no device work here: the streaming
consensus reaches the device through the embedder or the batcher).
``score`` holds only what multichat imports.
"""
