"""Host-side data helpers of the port: tokenizer and wav input and output."""
