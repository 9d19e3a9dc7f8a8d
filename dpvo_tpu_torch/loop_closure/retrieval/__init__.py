"""Place recognition for the classic loop-closure backend: the binary
bag-of-words database (``dbow``), its retrieval process
(``retrieval_dbow``) and the JPEG frame cache (``image_cache``)."""
