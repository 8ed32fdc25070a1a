"""Model families: ``families/<family>.py``, found by a configuration's
``family`` (``spec.family``).  Each module gives the seeded weights, the
port's served model built from them, the plain reference's scores, the
FLOP count and the attention bound, and the control (see ``README.md``).
``common.py`` holds what the families share and is no family."""
