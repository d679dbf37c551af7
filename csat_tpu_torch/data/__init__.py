"""Host-side data: collate, bucket ladder, AST matrices, synthetic requests."""
