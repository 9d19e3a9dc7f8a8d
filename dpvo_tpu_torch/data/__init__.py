"""Host-side data plane of the port: frame producers (``stream``) and the
training datasets (``tartan``, ``base``, ``factory``, ``loader``)."""
