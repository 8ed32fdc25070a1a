"""Encoders of the PyTorch port: configs, tokenizers, weight loading,
the BERT-class encoder and the embedder, the DeBERTa reward model and the
reranker the server calls.

Submodules are imported where they are used; importing this package
loads nothing else.
"""
