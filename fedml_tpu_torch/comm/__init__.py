"""The message runtime (port of ``fedml_tpu/comm``): the ``Message``
envelope and its wire codecs (``message.py``), the ``CommBackend`` /
``NodeManager`` protocol (``backend.py``) and the deterministic
in-process bus (``inproc.py``).  Over them run the cross-device FedAvg
managers (``algorithms/fedavg_cross_device.py``), SplitNN's message mode
(``algorithms/splitnn.py``) and the chaos wrapper (``faults/chaos.py``).
The TCP hub, its reactor, the shared-memory ring (``shm.py`` holds only
the frame helpers so far), the muxer and the edge hub come with the
transport's port (ROADMAP queue A item 5)."""
