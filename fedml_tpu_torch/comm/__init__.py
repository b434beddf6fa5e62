"""The message runtime (port of ``fedml_tpu/comm``): the ``Message``
envelope and its wire codecs (``message.py``), the ``CommBackend`` /
``NodeManager`` protocol (``backend.py``) and the deterministic
in-process bus (``inproc.py``).  The TCP hub and its relatives come
later (ROADMAP queue A item 5)."""
