"""Launch surface of the port: the RAG serving loop."""
