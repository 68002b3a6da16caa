"""HTTP routes of the port (aiohttp); the server, OpenAPI document and
Swagger UI are reused from vector_store_tpu.http."""
