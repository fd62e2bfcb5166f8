"""Host-side caches of the generative path: the KV prefix index."""
