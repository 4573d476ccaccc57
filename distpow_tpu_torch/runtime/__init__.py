"""Runtime support of the port: the metrics registry, the span ring, the
flight recorder, the device-hang watchdog, and the worker's RPC plane (the
wire codec, the RPC server and client, tracing, configuration, the
dominance cache, the fault plane, the resource sentinels): own copies of
the reference's ``runtime/`` modules of the same names."""
