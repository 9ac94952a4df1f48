"""HTTP server pieces (ports livetalking_tpu/server/): the session
manager and the business routes."""
