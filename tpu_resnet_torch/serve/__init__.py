"""Online inference: micro-batcher, checkpoint backend, HTTP server."""
