"""Traffic mixes (``<mix>.json``) and the kinds of traffic that draw and
drive them (``<kind>.py``, each with a ``Run`` class)."""
