"""OpenAPI document for the REST surface (parity with the reference's
utoipa-generated api/openapi.json; API version 3.0.0, httproutes.rs:102)."""

from __future__ import annotations

import vector_store_tpu_torch


def _pk_params():
    return [
        {
            "name": "keyspace",
            "in": "path",
            "required": True,
            "schema": {"$ref": "#/components/schemas/KeyspaceName"},
        },
        {
            "name": "index",
            "in": "path",
            "required": True,
            "schema": {"$ref": "#/components/schemas/IndexName"},
        },
    ]


def openapi_doc() -> dict:
    return {
        "openapi": "3.1.0",
        "info": {
            "title": "ScyllaDB Vector Store API",
            "description": (
                "REST API for ScyllaDB Vector Store indexing service. Provides "
                "capabilities for executing vector search queries, managing "
                "indexes, and checking service status."
            ),
            "license": {"name": "LicenseRef-ScyllaDB-Source-Available-1.0"},
            "version": vector_store_tpu_torch.API_VERSION,
        },
        "tags": [
            {
                "name": "scylla-vector-store-index",
                "description": (
                    "Operations for managing ScyllaDB Vector Store indexes, "
                    "including listing, counting, and searching."
                ),
            },
            {
                "name": "scylla-vector-store-info",
                "description": (
                    "Endpoints providing general information and status about "
                    "the ScyllaDB Vector Store indexing service."
                ),
            },
        ],
        "paths": {
            "/api/v1/indexes": {
                "get": {
                    "tags": ["scylla-vector-store-index"],
                    "operationId": "get_indexes",
                    "responses": {
                        "200": {
                            "description": "List of indexes managed by this node",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "type": "array",
                                        "items": {"$ref": "#/components/schemas/IndexInfo"},
                                    }
                                }
                            },
                        }
                    },
                }
            },
            "/api/v1/indexes/{keyspace}/{index}/status": {
                "get": {
                    "tags": ["scylla-vector-store-index"],
                    "operationId": "get_index_status",
                    "parameters": _pk_params(),
                    "responses": {
                        "200": {
                            "description": "Index status",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "$ref": "#/components/schemas/IndexStatusResponse"
                                    }
                                }
                            },
                        },
                        "404": {"description": "Index not found"},
                        "500": {"description": "Internal error"},
                    },
                }
            },
            "/api/v1/indexes/{keyspace}/{index}": {
                "get": {
                    "tags": ["scylla-vector-store-index"],
                    "operationId": "get_index_info",
                    "parameters": _pk_params(),
                    "responses": {
                        "200": {
                            "description": "Index info",
                            "content": {
                                "application/json": {
                                    "schema": {"$ref": "#/components/schemas/IndexInfo"}
                                }
                            },
                        },
                        "404": {"description": "Index not found"},
                    },
                }
            },
            "/api/v1/indexes/{keyspace}/{index}/ann": {
                "post": {
                    "tags": ["scylla-vector-store-index"],
                    "operationId": "post_index_ann",
                    "parameters": _pk_params(),
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "$ref": "#/components/schemas/PostIndexAnnRequest"
                                }
                            }
                        },
                        "required": True,
                    },
                    "responses": {
                        "200": {
                            "description": "ANN search results",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "$ref": "#/components/schemas/PostIndexAnnResponse"
                                    }
                                }
                            },
                        },
                        "400": {"description": "Bad request"},
                        "403": {"description": "TLS required"},
                        "404": {"description": "Index not found"},
                        "500": {"description": "Internal error"},
                        "503": {
                            "description": (
                                "Service Unavailable. The index is not ready to "
                                "serve requests."
                            ),
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "$ref": "#/components/schemas/IndexNotReadyReason"
                                    }
                                }
                            },
                        },
                    },
                }
            },
            "/api/v1/indexes/{keyspace}/{index}/bm25": {
                "post": {
                    "tags": ["scylla-vector-store-index"],
                    "operationId": "post_index_bm25",
                    "parameters": _pk_params(),
                    "requestBody": {
                        "content": {
                            "application/json": {
                                "schema": {
                                    "$ref": "#/components/schemas/PostIndexBm25Request"
                                }
                            }
                        },
                        "required": True,
                    },
                    "responses": {
                        "200": {
                            "description": "BM25 search results",
                            "content": {
                                "application/json": {
                                    "schema": {
                                        "$ref": "#/components/schemas/PostIndexBm25Response"
                                    }
                                }
                            },
                        },
                        "400": {"description": "Bad request"},
                        "404": {"description": "Index not found"},
                        "503": {"description": "Index not ready"},
                    },
                }
            },
            "/api/v1/info": {
                "get": {
                    "tags": ["scylla-vector-store-info"],
                    "operationId": "get_info",
                    "responses": {
                        "200": {
                            "description": "Service info",
                            "content": {
                                "application/json": {
                                    "schema": {"$ref": "#/components/schemas/InfoResponse"}
                                }
                            },
                        }
                    },
                }
            },
            "/api/v1/status": {
                "get": {
                    "tags": ["scylla-vector-store-info"],
                    "operationId": "get_status",
                    "responses": {
                        "200": {
                            "description": "Node status",
                            "content": {
                                "application/json": {
                                    "schema": {"$ref": "#/components/schemas/NodeStatus"}
                                }
                            },
                        }
                    },
                }
            },
        },
        "components": {
            "schemas": {
                "KeyspaceName": {"type": "string", "description": "A keyspace name in a db."},
                "IndexName": {
                    "type": "string",
                    "description": "A name of the vector index in a db.",
                },
                "ColumnName": {
                    "type": "string",
                    "description": "Name of the column in a db table.",
                },
                "Distance": {
                    "type": "number",
                    "format": "float",
                    "description": (
                        "Distance between vectors measured using the distance "
                        "function defined while creating the index."
                    ),
                },
                "SimilarityScore": {
                    "type": "number",
                    "format": "float",
                    "description": (
                        "Similarity score between vectors derived from the "
                        "distance. Higher score means more similar."
                    ),
                },
                "Limit": {"type": "integer", "format": "int32"},
                "Vector": {
                    "type": "array",
                    "items": {"type": "number", "format": "float"},
                    "description": (
                        "The vector to use for the Approximate Nearest Neighbor "
                        "search. The format of data must match the data_type of "
                        "the index."
                    ),
                },
                "DataType": {
                    "type": "string",
                    "enum": ["F32", "F16", "BF16", "I8", "B1"],
                    "description": (
                        "Data type and precision used for storing and processing "
                        "vectors in the index."
                    ),
                },
                "SimilarityFunction": {
                    "type": "string",
                    "enum": ["EUCLIDEAN", "COSINE", "DOT_PRODUCT", "HAMMING"],
                },
                "IndexStatus": {
                    "type": "string",
                    "enum": ["INITIALIZING", "BOOTSTRAPPING", "SERVING"],
                    "description": "Operational status of the vector index.",
                    "x-enum-descriptions": [
                        "The index has been discovered and is being initialized.",
                        "The index is performing the initial full scan of the underlying table to populate the index.",
                        "The index has completed the initial table scan. It is now monitoring the database for changes.",
                    ],
                },
                "NodeStatus": {
                    "type": "string",
                    "enum": [
                        "INITIALIZING",
                        "CONNECTING_TO_DB",
                        "BOOTSTRAPPING",
                        "SERVING",
                    ],
                    "description": (
                        "Operational status of the Vector Store indexing service."
                    ),
                    "x-enum-descriptions": [
                        "The node is starting up.",
                        "The node is establishing a connection to ScyllaDB.",
                        "The node is discovering available vector indexes in ScyllaDB.",
                        "The node has completed the initial database scan and built the indexes defined at that time. It is now monitoring the database for changes.",
                    ],
                },
                "VectorIndexOptions": {
                    "type": "object",
                    "required": [
                        "dimensions",
                        "maximum_node_connections",
                        "construction_beam_width",
                        "search_beam_width",
                        "similarity_function",
                        "quantization",
                    ],
                    "properties": {
                        "dimensions": {"type": "integer"},
                        "maximum_node_connections": {"type": "integer"},
                        "construction_beam_width": {"type": "integer"},
                        "search_beam_width": {"type": "integer"},
                        "similarity_function": {
                            "$ref": "#/components/schemas/SimilarityFunction"
                        },
                        "quantization": {"$ref": "#/components/schemas/DataType"},
                    },
                },
                "FulltextIndexOptions": {
                    "type": "object",
                    "required": ["analyzer", "positions"],
                    "properties": {
                        "analyzer": {"type": "string"},
                        "positions": {"type": "boolean"},
                    },
                },
                "IndexOptions": {
                    "oneOf": [
                        {"$ref": "#/components/schemas/VectorIndexOptions"},
                        {"$ref": "#/components/schemas/FulltextIndexOptions"},
                    ],
                    "discriminator": {"propertyName": "type"},
                },
                "IndexInfo": {
                    "type": "object",
                    "required": ["keyspace", "index", "options"],
                    "properties": {
                        "keyspace": {"$ref": "#/components/schemas/KeyspaceName"},
                        "index": {"$ref": "#/components/schemas/IndexName"},
                        "options": {"$ref": "#/components/schemas/IndexOptions"},
                    },
                },
                "IndexStatusResponse": {
                    "type": "object",
                    "required": ["status", "count"],
                    "properties": {
                        "status": {"$ref": "#/components/schemas/IndexStatus"},
                        "count": {"type": "integer"},
                        "build_progress": {
                            "type": "number",
                            "format": "double",
                            "minimum": 0,
                            "maximum": 100,
                            "default": 100.0,
                        },
                    },
                },
                "IndexNotReadyReason": {
                    "oneOf": [
                        {
                            "type": "object",
                            "required": ["reason"],
                            "properties": {
                                "reason": {"type": "string", "enum": ["NODE_BOOTSTRAPPING"]}
                            },
                        },
                        {
                            "type": "object",
                            "required": ["reason", "message"],
                            "properties": {
                                "reason": {"type": "string", "enum": ["INDEX_BUILDING"]},
                                "message": {"type": "string"},
                            },
                        },
                    ]
                },
                "InfoResponse": {
                    "type": "object",
                    "required": ["engine", "service", "version"],
                    "properties": {
                        "engine": {"type": "string"},
                        "service": {"type": "string"},
                        "version": {"type": "string"},
                    },
                },
                "PostIndexAnnFilter": {
                    "type": "object",
                    "required": ["restrictions"],
                    "properties": {
                        "restrictions": {
                            "type": "array",
                            "items": {
                                "$ref": "#/components/schemas/PostIndexAnnRestriction"
                            },
                        },
                        "allow_filtering": {"type": "boolean", "default": False},
                    },
                },
                "PostIndexAnnRestriction": {
                    "type": "object",
                    "required": ["type", "lhs", "rhs"],
                    "properties": {
                        "type": {
                            "type": "string",
                            "enum": [
                                "==", "IN", "<", "<=", ">", ">=",
                                "()==()", "()IN()", "()<()", "()<=()", "()>()", "()>=()",
                            ],
                        },
                        "lhs": {},
                        "rhs": {},
                    },
                },
                "PostIndexAnnRequest": {
                    "type": "object",
                    "required": ["vector"],
                    "properties": {
                        "vector": {"$ref": "#/components/schemas/Vector"},
                        "filter": {"$ref": "#/components/schemas/PostIndexAnnFilter"},
                        "limit": {"$ref": "#/components/schemas/Limit"},
                    },
                },
                "PostIndexAnnResponse": {
                    "type": "object",
                    "required": ["primary_keys", "distances", "similarity_scores"],
                    "properties": {
                        "primary_keys": {
                            "type": "object",
                            "additionalProperties": {"type": "array", "items": {}},
                        },
                        "distances": {
                            "type": "array",
                            "items": {"$ref": "#/components/schemas/Distance"},
                        },
                        "similarity_scores": {
                            "type": "array",
                            "items": {"$ref": "#/components/schemas/SimilarityScore"},
                        },
                    },
                },
                "PostIndexBm25Request": {
                    "type": "object",
                    "required": ["query"],
                    "properties": {
                        "query": {"type": "string"},
                        "limit": {"$ref": "#/components/schemas/Limit"},
                    },
                },
                "PostIndexBm25Response": {
                    "type": "object",
                    "required": ["primary_keys", "scores"],
                    "properties": {
                        "primary_keys": {
                            "type": "object",
                            "additionalProperties": {"type": "array", "items": {}},
                        },
                        "scores": {
                            "type": "array",
                            "items": {"type": "number", "format": "float"},
                        },
                    },
                },
            }
        },
    }
