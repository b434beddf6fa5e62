"""The message runtime (port of ``fedml_tpu/comm``): the ``Message``
envelope and its wire codecs (``message.py``), the ``CommBackend`` /
``NodeManager`` protocol (``backend.py``), the deterministic in-process
bus (``inproc.py``) and the TCP transport: the hub in its reactor and
threaded data planes and the ``TcpBackend`` (``tcp.py``), the reactor's
frame parser and pooled buffers (``reactor.py``), the shared-memory
lanes (``shm.py``), the muxer's virtual nodes over one connection
(``mux.py``) and the edge tier's uplink (``edge.py``).  Over them run
the cross-device FedAvg managers (``algorithms/fedavg_cross_device.py``,
``fedavg_mux.py``, ``edge_hub.py``; as processes,
``experiments/distributed_fedavg.py``), SplitNN's message mode
(``algorithms/splitnn.py``) and the chaos wrapper (``faults/chaos.py``).
Frames, registration and lanes are the JAX package's byte for byte, so
port and JAX peers share one hub."""
