"""The HTTP/1.1 wire on asyncio streams alone: the pooled client the
engine's remote graph hops use (``h1client.py``) and the request reading
and body parsing the engine and the wrapper runtime share
(``h1server.py``)."""
