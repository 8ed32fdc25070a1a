"""Performance analysis of the port: the per-bucket speed-of-light
roofline (``roofline.py``, committed as ``roofline.json``) and the
FLOP and byte counter that writes it (``cost.py``).

Counterpart of the reference's ``analysis/roofline.py``; the rest of the
reference's ``analysis/`` (the static-analysis engine, its rules and the
audits) waits for ROADMAP queue 1, item 6.
"""
