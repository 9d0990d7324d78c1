"""The benchmark's own tests: CPU ones at tiny sizes, card ones marked
``cuda`` (they skip without a card)."""
