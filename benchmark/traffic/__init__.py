"""Traffic: ``requests.py`` turns a mix (a ``workloads/<cell>.json``) and
a seed into request bodies; a generator (``closed_loop.py``,
``open_loop.py``, named by the mix's ``generator``) drives them over
HTTP through the measured window."""
