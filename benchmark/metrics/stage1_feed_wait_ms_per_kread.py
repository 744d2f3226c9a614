"""Stage 1's count loop blocked on the feeder thread's parse + encode (pipeline/stage1_kmers._streamed_count's queue wait): STAGE_SECONDS["1.feed_wait"] (span asv:1.feed_wait) per 1,000 reads."""
from benchmark import readers


def read(record):
    return readers.ms_per_kread(record, "stage_s", "1.feed_wait")
