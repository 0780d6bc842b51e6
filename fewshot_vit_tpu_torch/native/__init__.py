"""Host-side native code of the port: the exact EMD solver (``emd.py``)."""
