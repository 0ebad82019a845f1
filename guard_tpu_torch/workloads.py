"""Workloads of the port, as plain data.

The port's own copies of the JAX package's benchmark and flagship
inputs, so that `chip_smoke.py` and the tests need neither `bench.py`
nor `__graft_entry__.py`:

  * `RULES` / `make_template` — the 4-rule security-policy set and the
    seeded CloudFormation template generator (bench.py:45-68, 142-174);
  * `FLAGSHIP_RULES` / `example_docs` — the s3-bucket-sse slice and its
    example documents (__graft_entry__.py `_RULES`, `_example_docs`);
  * `HOST_ORACLE_RULES` — the flagship plus a `now()` rule, which stays
    on the host oracle (__graft_entry__.py `_DRYRUN_RULES`);
  * `volume_template` — one template of many EC2 volumes, to fill the
    largest node bucket;
  * `XREF_RULES` / `make_xref_template` — a cross-reference policy whose
    rules compare queries with queries and interpolate `.%var` keys,
    over templates with Parameters, Auto Scaling groups and Metadata;
  * `FNVAR_RULES` / `make_fnvar_template` — the per-resource
    canonical-form checks of examples/rules/naming/canonical_names.guard
    plus a function `let` and an inline call, over templates with S3
    buckets, EC2 instances, environment tags and Parameters.

Documents are plain dicts/lists (JSON-shaped).
"""

from __future__ import annotations

RULES = """
let s3_buckets = Resources.*[ Type == 'AWS::S3::Bucket' ]
let volumes = Resources.*[ Type == 'AWS::EC2::Volume' ]

rule s3_bucket_sse when %s3_buckets !empty {
    %s3_buckets.Properties.BucketEncryption.ServerSideEncryptionConfiguration[*]
        .ServerSideEncryptionByDefault.SSEAlgorithm IN ['aws:kms', 'AES256']
}

rule s3_bucket_name when %s3_buckets !empty {
    %s3_buckets.Properties.BucketName == /^[a-z0-9.-]{3,63}$/ or
    %s3_buckets.Properties.BucketName !exists
}

rule volume_encrypted when %volumes !empty {
    %volumes.Properties.Encrypted == true
    %volumes.Properties.Size IN r[1,16384]
}

rule no_public_buckets when %s3_buckets !empty {
    %s3_buckets.Properties.PublicAccessBlockConfiguration.BlockPublicAcls == true or
    %s3_buckets.Properties.AccessControl != 'PublicRead'
}
"""

FLAGSHIP_RULES = """
let s3_buckets = Resources.*[ Type == 'AWS::S3::Bucket' ]

rule s3_bucket_sse when %s3_buckets !empty {
    %s3_buckets.Properties.BucketEncryption exists
    %s3_buckets.Properties.BucketEncryption.ServerSideEncryptionConfiguration[*]
        .ServerSideEncryptionByDefault.SSEAlgorithm IN ['aws:kms', 'AES256']
}

rule s3_bucket_name_compliant when %s3_buckets !empty {
    %s3_buckets.Properties.BucketName == /^[a-z0-9.-]{3,63}$/ or
    %s3_buckets.Properties.BucketName !exists
}
"""

HOST_ORACLE_RULES = FLAGSHIP_RULES + """
rule freshness_guard {
    let ts = now()
    %ts exists
}
"""


# Cross-reference policy: every rule reaches a join of the walk.
#   sse_allowed               In against a shared root-bound RHS (K4)
#   volume_size_cap           ordering against a shared RHS (K6)
#   asg_capacity_ordered      ordering against a per-origin RHS (K6)
#   audited_are_buckets       `.%var` key interpolation (K4, K5)
#   reviewed_matches_audited  Eq under `not` at rule level (K4)
XREF_RULES = """
let s3_buckets = Resources.*[ Type == 'AWS::S3::Bucket' ]
let volumes = Resources.*[ Type == 'AWS::EC2::Volume' ]
let asgs = Resources.*[ Type == 'AWS::AutoScaling::AutoScalingGroup' ]
let allowed = Parameters.AllowedAlgorithms.AllowedValues
let max_size = Parameters.MaxVolumeSize.Default
let audited = Metadata.AuditedResources

rule sse_allowed when %s3_buckets !empty {
    %s3_buckets {
        Properties.BucketEncryption.ServerSideEncryptionConfiguration[*]
            .ServerSideEncryptionByDefault.SSEAlgorithm IN %allowed
    }
}

rule volume_size_cap when %volumes !empty {
    %volumes {
        Properties.Size <= %max_size
    }
}

rule asg_capacity_ordered when %asgs !empty {
    %asgs {
        Properties.MinSize <= Properties.MaxSize
        Properties.DesiredCapacity >= Properties.MinSize
    }
}

rule audited_are_buckets when %audited !empty {
    Resources.%audited.Type == 'AWS::S3::Bucket'
}

rule reviewed_matches_audited when %audited !empty {
    Metadata.ReviewedResources != %audited
}
"""


# Function-variable policy: the three rules of
# examples/rules/naming/canonical_names.guard (the quota call behind a
# when-block, so a non-numeric quota SKIPs instead of raising), then
#   environment_known   a file-level function let ('fn' slot) checked
#                       with IN a literal list
#   stack_name_ordered  an inline call on a root-basis clause ('expr'),
#                       which skips (not raises) where its argument is
#                       missing
# The other slots: to_lower per bucket and parse_int per instance
# ('pexpr'), %want per resource in the Tags filter ('pvar').
FNVAR_RULES = """
rule bucket_names_lowercase when Resources exists {
    AWS::S3::Bucket {
        # the canonical form of THIS bucket's name
        Properties.BucketName == to_lower(Properties.BucketName)
        <<
          bucket names must already be in canonical lowercase form
        >>
    }
}

rule instance_size_within_class_quota when Resources exists {
    AWS::EC2::Instance {
        # quota is carried per instance as a string attribute
        when Properties.ClassQuota == /^[0-9]+$/ {
            Properties.VolumeSize <= parse_int(Properties.ClassQuota)
        }
    }
}

rule tags_match_resource_env when Resources exists {
    Resources.* {
        when Properties.Env exists {
            let want = Properties.Env
            # every tag group of this resource must name ITS env
            Properties.Tags[ Env == %want ] !empty
        }
    }
}

let env = to_lower(Parameters.Environment)

rule environment_known when Parameters exists {
    %env IN ['prod', 'staging', 'dev']
}

rule stack_name_ordered when Parameters exists {
    Parameters.StackName == regex_replace(Parameters.Deployment, '^(\\w+)/(\\w+)$', '${2}-${1}')
}
"""


def make_template(rng, i: int) -> dict:
    resources = {}
    for b in range(int(rng.integers(1, 4))):
        resources[f"bucket{b}"] = {
            "Type": "AWS::S3::Bucket",
            "Properties": {
                "BucketName": f"prod-logs-{i}-{b}",
                "AccessControl": str(rng.choice(["Private", "PublicRead"])),
                "PublicAccessBlockConfiguration": {
                    "BlockPublicAcls": bool(rng.random() < 0.8)
                },
                "BucketEncryption": {
                    "ServerSideEncryptionConfiguration": [
                        {
                            "ServerSideEncryptionByDefault": {
                                "SSEAlgorithm": str(
                                    rng.choice(["aws:kms", "AES256", "none"])
                                )
                            }
                        }
                    ]
                },
            },
        }
    for v in range(int(rng.integers(0, 3))):
        resources[f"vol{v}"] = {
            "Type": "AWS::EC2::Volume",
            "Properties": {
                "Encrypted": bool(rng.random() < 0.7),
                "Size": int(rng.integers(1, 20000)),
            },
        }
    return {"Resources": resources}


def make_xref_template(rng, i: int) -> dict:
    """`make_template` plus what XREF_RULES cross-references: Parameters
    (the allowed SSE algorithms, a volume size cap), 0-2 Auto Scaling
    groups whose sizes are sometimes out of order, and Metadata lists of
    audited and reviewed logical ids. Every interpolated value is a
    string and no IN pairs a list with a list, so no document needs the
    host oracle."""
    doc = make_template(rng, i)
    resources = doc["Resources"]
    for a in range(int(rng.integers(0, 3))):
        low = int(rng.integers(0, 4))
        high = low + int(rng.integers(0, 8))
        desired = int(rng.integers(low, high + 1))
        if rng.random() < 0.1:
            low, high = high + 1, low  # MinSize above MaxSize
        if rng.random() < 0.1:
            desired = max(0, low - 1)  # DesiredCapacity below MinSize
        resources[f"asg{a}"] = {
            "Type": "AWS::AutoScaling::AutoScalingGroup",
            "Properties": {"MinSize": low, "MaxSize": high, "DesiredCapacity": desired},
        }
    allowed = ["aws:kms", "AES256"] if rng.random() < 0.8 else ["aws:kms"]
    doc["Parameters"] = {
        "AllowedAlgorithms": {
            "Type": "String", "Default": allowed[0], "AllowedValues": allowed,
        },
        "MaxVolumeSize": {
            "Type": "Number", "Default": int(rng.choice([4096, 16384])),
        },
    }
    audited = [k for k, v in resources.items() if v["Type"] == "AWS::S3::Bucket"]
    others = [k for k, v in resources.items() if v["Type"] != "AWS::S3::Bucket"]
    if others and rng.random() < 0.2:
        audited.append(str(rng.choice(others)))  # audits a non-bucket
    if rng.random() < 0.05:
        audited.append(f"retired{i}")  # a logical id the template lacks
    reviewed = list(audited)
    if rng.random() < 0.15:
        reviewed = reviewed[:-1]  # one review behind
    doc["Metadata"] = {"AuditedResources": audited, "ReviewedResources": reviewed}
    return doc


def example_docs(n: int, two_buckets: bool = False) -> list:
    """`two_buckets` pads every other document with extra resources so
    the batch spans TWO node-size buckets (encoder.NODE_BUCKETS) and
    the bucketed evaluation path is exercised, including a FAILING
    document (missing encryption) in each bucket."""
    docs = []
    for i in range(n):
        resources = {
            f"bucket{i}": {
                "Type": "AWS::S3::Bucket",
                "Properties": {
                    "BucketName": f"prod-logs-{i}",
                    "BucketEncryption": {
                        "ServerSideEncryptionConfiguration": [
                            {
                                "ServerSideEncryptionByDefault": {
                                    "SSEAlgorithm": "aws:kms"
                                    if i % 2
                                    else "AES256"
                                }
                            }
                        ]
                    },
                },
            },
            "vol": {"Type": "AWS::EC2::Volume"},
        }
        if i % 3 == 0:
            # non-compliant bucket: the sse rule FAILs on this doc
            resources[f"bucket{i}"]["Properties"].pop("BucketEncryption")
        if two_buckets and i % 2 == 0:
            for j in range(24):  # push past the 64-node bucket
                resources[f"pad{j}"] = {
                    "Type": "AWS::EC2::Volume",
                    "Properties": {"Size": j},
                }
        docs.append({"Resources": resources})
    return docs


def volume_template(n_volumes: int) -> dict:
    """One template of `n_volumes` AWS::EC2::Volume resources: five
    nodes each, so 12,000 volumes (about 60k nodes) land in the
    65,536-node bucket."""
    return {
        "Resources": {
            f"vol{v}": {
                "Type": "AWS::EC2::Volume",
                "Properties": {"Encrypted": v % 7 != 0, "Size": 1 + v % 20000},
            }
            for v in range(n_volumes)
        }
    }


def make_fnvar_template(rng, i: int, exotic: bool = False) -> dict:
    """A template for FNVAR_RULES: 1-2 S3 buckets (a fifth of the names
    in mixed case), 0-2 EC2 instances with a VolumeSize and a string
    ClassQuota (one in twenty not numeric), an environment and tag
    groups on some resources (one group in ten naming another env), and
    Parameters with an Environment in any case and a stack name that
    mostly equals its deployment's parts in reverse order. `exotic` adds a number with no
    exact device encoding (an integer beyond 64 bits), which sends the
    template to the CPU oracle."""
    envs = ["prod", "staging", "dev"]
    env = str(rng.choice(envs))
    resources = {}

    def tags(own: str) -> list:
        out = []
        for _ in range(int(rng.integers(1, 3))):
            e = own if rng.random() < 0.9 else str(rng.choice(envs))
            out.append({"Env": e, "Team": f"team{int(rng.integers(0, 8))}"})
        return out

    for b in range(int(rng.integers(1, 3))):
        name = f"logs-{env}-{i}-{b}"
        if rng.random() < 0.2:
            name = name.title()
        props = {"BucketName": name}
        if rng.random() < 0.5:
            props["Env"] = env
            props["Tags"] = tags(env)
        resources[f"bucket{b}"] = {"Type": "AWS::S3::Bucket", "Properties": props}
    for k in range(int(rng.integers(0, 3))):
        quota = str(int(rng.choice([100, 500, 1000])))
        if rng.random() < 0.05:
            quota = "unlimited"
        props = {"VolumeSize": int(rng.integers(8, 1200)), "ClassQuota": quota}
        if rng.random() < 0.5:
            props["Env"] = env
            props["Tags"] = tags(env)
        resources[f"inst{k}"] = {"Type": "AWS::EC2::Instance", "Properties": props}
    shown = str(rng.choice([env, env.upper(), env.title()]))
    if rng.random() < 0.05:
        shown = "qa"  # not a known environment
    stack = f"{env}-app{i}" if rng.random() < 0.9 else f"app{i}-{env}"
    doc = {
        "Resources": resources,
        "Parameters": {"Environment": shown, "Deployment": f"app{i}/{env}",
                       "StackName": stack},
    }
    if exotic:
        doc["Metadata"] = {"BuildNumber": 2**70 + i}
    return doc
