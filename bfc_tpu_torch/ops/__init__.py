"""Device operations: k-mer stream, run building, table probe, annotation, search."""
