"""Serving: InferenceEngine, MicroBatcher and the HTTP server."""
