"""Runtime support of the port: the metrics registry, the span ring, the
flight recorder, the device-hang watchdog, the runtime lock-order audit
(``lockcheck``), and the RPC plane (the wire
codec, the RPC server and client, tracing, the tracing server and the
trace-log checker, configuration, the dominance cache, the fault plane,
the resource sentinels): own copies of the reference's ``runtime/``
modules of the same names.  None of them imports ``torch``."""
