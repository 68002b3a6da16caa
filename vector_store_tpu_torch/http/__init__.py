"""HTTP routes of the port (aiohttp); the server, OpenAPI document and
Swagger UI are copies of vector_store_tpu.http's."""
