"""Host-side data plane of the port (frame producers)."""
