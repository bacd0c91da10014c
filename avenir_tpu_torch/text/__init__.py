"""Text analysis: tokenizer, Porter stemmer, word counting."""

from avenir_tpu_torch.text.analyzer import STOPWORDS, analyze_lines, porter_stem, tokenize
from avenir_tpu_torch.text.wordcount import WordCount

__all__ = ["STOPWORDS", "analyze_lines", "porter_stem", "tokenize", "WordCount"]
