"""Out-of-process hooks (SURVEY.md §1 L6) — parity with
``apps/emqx_exhook``: external HookProvider services receive broker
hook events over RPC and may rewrite/deny. The wire is the cluster
codec's length-prefixed framing (the grpc-erl slot; this image carries
no gRPC runtime, the service surface mirrors exhook.proto 1:1)."""
