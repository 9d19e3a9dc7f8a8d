"""Loop closure of the port: proximity edge proposals (``proximity``) and
the classic backend (``long_term``, with ``pgo``, ``optim_utils`` and
``retrieval``)."""
