"""setup_s: seconds from the start of the process to the first timed
request (build, conversion on a first run, load, encryption of the pool,
warm-up), host clock."""


def read(record):
    return record["setup_s"]
