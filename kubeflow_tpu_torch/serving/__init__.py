"""Serving: sampling, the generate oracle, the paged decode engine and
the REST model server."""
