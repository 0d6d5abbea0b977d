"""Host-side distributed-serving helpers of the port."""
