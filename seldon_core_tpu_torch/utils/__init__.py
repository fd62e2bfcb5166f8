"""Host utilities: the Prometheus registry (``metrics.py``) and the roofline
(``roofline.py``)."""
