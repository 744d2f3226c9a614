"""Tuned constants, mirroring the reference's src/constants.rs."""

ASV_FILE = "final_asvs.fasta"                 # constants.rs:2
MAX_INSERTION_LENGTH = 2                      # constants.rs:3
MID_BASE_THRESHOLD_READ = 25                  # constants.rs:12 (98%)
DEFAULT_ERR_RATE = 0.02                       # constants.rs:35
MAX_KMER_COUNT_IN_READ = 500                  # constants.rs:46
QUALITY_SEQ_BIN = 4                           # constants.rs:48
MINIMUM_MINIMIZER_FRACTION = 0.10             # constants.rs:50
MAGIC_EXIST_STRING = "exist"                  # constants.rs:52
MAX_SEQS_CONSENSUS = 250                      # constants.rs:60
DEDUP_SNPMERS = True                          # constants.rs:65
LSH_NUM_TABLES = 20                           # constants.rs:67
LSH_BUCKET_SIZE = 3                           # constants.rs:68
USE_SOLID_KMERS = False                       # constants.rs:44

# Stage-2 greedy clustering (asv_cluster.rs:80-84)
KMER_CLUSTER_THRESHOLD = 0.950
TOP_N_LSH_CANDIDATES = 10

# Stage-4 consensus (alignment.rs:219,414)
MAX_SEQS_POA = 75

# Stage-7 EM (alignment.rs:1798-1822)
EM_MINIMIZER_RATIO_BASE = 0.950
EM_RATIO_THRESHOLD = 0.0050
EM_MAX_ITERATIONS = 10000

# classify EM (classify.rs:33)
CLASSIFY_EM_MAX_ITERATIONS = 1000

# sintax (sintax.rs:13-14)
SINTAX_K = 12
SINTAX_SUBSAMPLE = 32
