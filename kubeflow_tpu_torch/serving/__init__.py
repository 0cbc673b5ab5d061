"""Serving: sampling, the generate oracle, the paged decode engine, the
`:predict` path (ServedModel and the micro-batcher) and the REST model
server."""
