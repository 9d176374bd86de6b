"""Host-side data helpers of the port: tokenizer and wav output."""
