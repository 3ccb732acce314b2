"""ANN path: flat inner-product index (the FAISS IndexFlatIP equivalent of
reference src/jaccard.py) with fused dot+top-k search on the accelerator."""
