"""Loop closure of the port: proximity edge proposals (``proximity``)."""
